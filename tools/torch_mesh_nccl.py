"""The mesh step across the cards of one host over NCCL: each mesh against
one process, and its speed beside one card's.

    torchrun --nproc_per_node=4 tools/torch_mesh_nccl.py [--batch 1024] [--timed 6]

from the root of a checkout, one rank per card (``--device=cuda`` is each
rank's ``cuda:LOCAL_RANK``).  It imports nothing of JAX.  The model is
chip_smoke's data_parallel configuration (Willow NetVLADModelLF at full
width in f32 with the training kernels, lr 1e-4, weights and batches from
seeds), the batch ``--batch`` videos over all ranks.

1. Rank 0 alone takes two steps on the whole batch (the reference) and
   times ``--timed`` more, then ``--timed`` steps on one rank's share of
   the batch (what one card does in a data-parallel step).  The reference's
   parameters reach every rank by NCCL broadcast.
2. For each layout of the ranks (data × model: N×1, N/2×2, 1×N), two steps
   from the same weights on the same batches: the losses against the
   reference's within chip_smoke's DP_LOSS_GATE, the parameters within
   DP_PARAM_GATE (each rank its columns of a split one); then ``--timed``
   steps by CUDA events, the slowest rank's median.

One JSON line per layout, then one with the reference's times, the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from learnablepoolingmethods_torch.core.weights import init_variables_np  # noqa: E402
from learnablepoolingmethods_torch.parallel import mesh as mesh_lib  # noqa: E402


def slowest_median(ms, dev) -> float:
    """The median step ms, the largest over the ranks."""
    t = torch.tensor(statistics.median(ms), device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--timed", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    dev = mesh_lib.distributed_init(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    mcfg, fcfg, _ = chip_smoke.dp_config()
    tree = init_variables_np(mcfg, fcfg, seed=0, model_name="NetVLADModelLF")
    batches = chip_smoke.dp_batches(2, args.batch)
    timing = [batches[0]] * args.timed
    share = {k: v[: args.batch // world] for k, v in batches[0].items()}

    ref_losses, ref, one_card = None, {}, {}
    if rank == 0:
        ref_losses, _, state, _ = chip_smoke.dp_train(dev, tree, batches)
        ref = {f"params/{n.replace('.', '/')}": (p.detach(),) for n, p in state.model.named_parameters()}
        del state
        one_card["whole_batch_ms"] = statistics.median(chip_smoke.dp_train(dev, tree, timing)[1][1:])
        one_card["share_ms"] = statistics.median(chip_smoke.dp_train(dev, tree, [share] * args.timed)[1][1:])
        torch.cuda.empty_cache()
    box = [ref_losses, sorted((name, tuple(t[0].shape)) for name, t in ref.items())]
    dist.broadcast_object_list(box, src=0)
    ref_losses, shapes = box
    if rank != 0:
        ref = {name: (torch.empty(shape, device=dev),) for name, shape in shapes}
    for name, _ in shapes:
        dist.broadcast(ref[name][0], src=0)

    layouts = [(world, 1), (world // 2, 2), (1, world)] if world >= 4 else [(world, 1), (1, world)]
    for data, model in layouts:
        mesh = mesh_lib.create_mesh(model_parallelism=model)
        losses, _, state, split = chip_smoke.dp_train(dev, tree, batches, mesh)
        gap = chip_smoke.dp_param_gap(state.model, ref, mesh)
        totals = torch.tensor([gap["max_abs"], gap["over"], gap["entries"]], dtype=torch.float64, device=dev)
        worst = totals[:1].clone()
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        dist.all_reduce(totals)
        del state
        torch.cuda.empty_cache()
        step_ms = slowest_median(chip_smoke.dp_train(dev, tree, timing, mesh)[1][1:], dev)
        torch.cuda.empty_cache()
        if rank == 0:
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            over, entries = int(totals[1]), int(totals[2])
            ok = (loss_gap <= chip_smoke.DP_LOSS_GATE and float(worst) <= chip_smoke.DP_PARAM_GATE["max_abs"]
                  and over <= chip_smoke.DP_PARAM_GATE["max_over"])
            print(json.dumps({"layout": f"{data}x{model}", "ranks": world, "batch": args.batch, "split": split,
                              "losses": losses, "reference_losses": ref_losses, "loss_gap": loss_gap,
                              "param_max_abs": float(worst), "param_over": over, "param_entries": entries,
                              "within_gates": ok, "step_ms": step_ms,
                              "videos_per_s": args.batch / (step_ms / 1e3)}), flush=True)
            if not ok:
                raise AssertionError(f"{data}x{model}: outside the gates")
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()
        print(json.dumps({"one_card": {"batch": args.batch, **one_card,
                                       "whole_batch_videos_per_s": args.batch / (one_card["whole_batch_ms"] / 1e3),
                                       "share_videos_per_s": args.batch // world / (one_card["share_ms"] / 1e3)},
                          "cards": smi}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
