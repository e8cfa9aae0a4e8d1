"""Multi-process smoke run: bootstrap, one sharded train step and one epoch
(counterpart of ``glass_tpu/parallel/multihost.py``, with its flags).

Start one process per rank, each with the same flags and its own
``--process_id``:

    python -m glass_tpu_torch.parallel.multihost --coordinator localhost:29500 \\
        --num_processes 2 --process_id 0 --cpu_collectives gloo \\
        --graph_shards 2 --device -1

(or under torchrun with none of the three coordinator flags). Every process
builds the same problem from the same seed, runs one ShardedTrainer step and
one epoch, and prints the losses, which equal the one-process
:func:`run_smoke`'s to float tolerance: the model's dropout (0.1) draws the
same masks however the graph is sharded.
"""

from __future__ import annotations

import argparse

import numpy as np


def smoke_problem(seed: int = 0):
    """The deterministic toy problem every process builds identically."""
    rng = np.random.default_rng(seed)
    n, e = 64, 256
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    batch, sub_len = 4, 4
    pos = np.stack(
        [rng.choice(n, size=sub_len, replace=False) for _ in range(batch)])
    y = rng.integers(0, 3, size=batch)
    x = rng.integers(0, 5, size=(n, 1)).astype(np.int64)
    return ei, n, x, pos, y


def run_smoke(graph_shards: int, data_shards: int = None,
              device="cuda") -> dict:
    """One sharded train step and one epoch on the smoke problem, on this
    process's ranks of a (data_shards, graph_shards) mesh. Returns
    {'step_loss', 'epoch_loss'} as floats, equal on every rank."""
    from glass_tpu_torch.nn.modules import GLASS
    from glass_tpu_torch.parallel.mesh import make_mesh
    from glass_tpu_torch.parallel.partition import partition_graph
    from glass_tpu_torch.parallel.train import ShardedTrainer
    from glass_tpu_torch.train.loop import TrainConfig

    ei, n, x, pos, y = smoke_problem()
    model = GLASS(max_deg=4, hidden_channels=8, num_layers=2,
                  output_channels=(3,), pools=("size",), dropout=0.1,
                  activation="elu", z_ratio=0.8, jk=True, device=device)
    cfg = TrainConfig(lr=1e-3, batch_size=pos.shape[0], loss="ce", use_z=True)
    mesh = make_mesh(graph_shards=graph_shards, data_shards=data_shards)
    pg = partition_graph(ei, None, n, "gcn", graph_shards)
    trainer = ShardedTrainer(model, pg, x, cfg, mesh)
    trainer.init(0)
    step_loss = trainer.train_step(pos, y)
    epoch = trainer.train_epoch(pos[None], y[None])
    return {"step_loss": step_loss, "epoch_loss": epoch.loss}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", type=str, default=None,
                    help="host:port of process 0 (none of the three "
                         "coordinator flags: torchrun's environment)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--cpu_collectives", type=str, default=None,
                    choices=["gloo", "mpi"],
                    help="the collectives' backend (default: NCCL with a "
                         "card, gloo without)")
    ap.add_argument("--local_devices", type=int, default=None,
                    help="devices of this process: 1 (a rank owns one)")
    ap.add_argument("--graph_shards", type=int, default=1)
    ap.add_argument("--data_shards", type=int, default=None)
    ap.add_argument("--device", type=int, default=0,
                    help="-1 runs on the CPU; otherwise the CUDA card")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from glass_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        cpu_collectives=args.cpu_collectives,
        local_cpu_devices=args.local_devices,
    )
    pid = dist.get_rank()
    print(f"[p{pid}] processes={dist.get_world_size()} "
          f"backend={dist.get_backend()}", flush=True)
    out = run_smoke(args.graph_shards, args.data_shards,
                    device="cpu" if args.device == -1 else "cuda")
    print(f"[p{pid}] step_loss={out['step_loss']:.10f} "
          f"epoch_loss={out['epoch_loss']:.10f}", flush=True)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
