"""Time one expert-parallel MoE layer of each of several checkouts on four
cards, for A/B comparisons of the expert exchange.

Usage, on a machine with four cards, from any directory::

    python3 paddle_tpu_torch/tools/ep_ab.py CHECKOUT [CHECKOUT ...]

For each checkout in turn (name one twice, in the order parent, change,
change, parent, to see the spread), four NCCL ranks, one per card, import
that checkout's ``paddle_tpu_torch`` and run its
``distributed.moe.moe_dispatch_combine`` ("sort", silu) forward and
backward at one DeepSeekMoE-16B layer (``deepseek_moe_16b()``: 8 x 512
tokens, hidden 2048, 64 experts top-6, expert FFN 1408, bf16; the
router in f32) on a 1-D ep mesh of the four ranks: each rank its 16
experts, every rank the same tokens (dp 1, as 24b runs the model).
After WARMUP calls, ITERS timed ones; one more under ``torch.profiler``.
Prints one JSON line per checkout, the cards' ``nvidia-smi`` name and
power limit in it: each rank's wall ms a call (ended by a synchronize)
and CUDA-event ms, and the NCCL kernels' share of the profiled call's
device time (NCCL kernels spin while a peer is late).
"""
import json
import os
import queue
import socket
import subprocess
import sys
import time

import numpy as np

EP = 4
TOKENS, HIDDEN, EXPERTS, TOP_K, FFN = 8 * 512, 2048, 64, 6, 1408
WARMUP, ITERS = 5, 20
WALL_S = 300                       # one checkout's ranks, at most


def worker(rank, root, port, results):
    """One NCCL rank: puts (rank, ok, record or traceback) on
    ``results``."""
    import traceback
    sys.path.insert(0, root)
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    try:
        from paddle_tpu_torch import distributed as D
        from paddle_tpu_torch.distributed import ProcessMesh
        from paddle_tpu_torch.distributed import moe as TM
        D.init_parallel_env(device="cuda", rank=rank, world_size=EP,
                            init_method=f"tcp://localhost:{port}",
                            timeout_s=WALL_S)
        mesh = ProcessMesh(np.arange(EP), ["ep"])
        gen = torch.Generator(device="cuda").manual_seed(0)

        def rand(*shape, std):
            return torch.randn(*shape, device="cuda", generator=gen) * std

        el = EXPERTS // EP
        mine = slice(rank * el, (rank + 1) * el)
        bf = torch.bfloat16
        leaves = [rand(TOKENS, HIDDEN, std=1.0).to(bf),
                  rand(HIDDEN, EXPERTS, std=HIDDEN ** -0.5),
                  rand(EXPERTS, HIDDEN, FFN, std=HIDDEN ** -0.5)[mine]
                  .to(bf),
                  torch.zeros(el, FFN, dtype=bf, device="cuda"),
                  rand(EXPERTS, FFN, HIDDEN, std=FFN ** -0.5)[mine].to(bf),
                  torch.zeros(el, HIDDEN, dtype=bf, device="cuda")]
        leaves = [t.contiguous().requires_grad_() for t in leaves]
        dy = rand(TOKENS, HIDDEN, std=1.0).to(bf)

        def call():
            y, aux = TM.moe_dispatch_combine(
                *leaves, top_k=TOP_K, activation=F.silu, mesh=mesh)
            torch.autograd.grad((y * dy).sum() + aux, leaves)

        for _ in range(WARMUP):
            call()
        torch.cuda.synchronize()
        dist.barrier()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(ITERS):
            call()
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / ITERS * 1e3
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        busy = nccl = 0.0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                us = ev.time_range.elapsed_us()
                busy += us
                if "nccl" in ev.name.lower():
                    nccl += us
        results.put((rank, True, {
            "source": os.path.dirname(TM.__file__), "wall_ms": wall,
            "event_ms": start.elapsed_time(end) / ITERS,
            "device_busy_ms": busy / 1e3, "nccl_ms": nccl / 1e3}))
    except BaseException:                       # noqa: BLE001 - reported
        results.put((rank, False, traceback.format_exc()))
    finally:
        # an NCCL group is aborted, not destroyed: a destroy waits on peers
        abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
        if dist.is_initialized() and abort is not None:
            abort()
        elif dist.is_initialized():
            dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(root, card):
    """One checkout's four ranks; returns its JSON record.  Every rank
    is stopped before it returns."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=worker, args=(r, root, port, results))
             for r in range(EP)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.perf_counter() + WALL_S
    try:
        while len(got) + len(errors) < EP:
            try:
                rank, ok, res = results.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue.Empty:
                errors.append(f"no result from every rank in {WALL_S} s")
                break
            if ok:
                got[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    ranks = [got[r] for r in range(EP)]
    source = ranks[0].pop("source")
    for r in ranks[1:]:
        r.pop("source")
    return {"checkout": root, "source": source, "card": card, "ep": EP,
            "layer": {"tokens": TOKENS, "hidden": HIDDEN,
                      "experts": EXPERTS, "top_k": TOP_K, "ffn": FFN},
            "iters": ITERS,
            **{k: [r[k] for r in ranks] for k in ranks[0]},
            "nccl_share": [r["nccl_ms"] / r["device_busy_ms"]
                           if r["device_busy_ms"] else None for r in ranks]}


def main(roots):
    import torch
    if torch.cuda.device_count() < EP:
        print(f"ep_ab: needs {EP} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for root in roots:
        print(json.dumps(run(os.path.abspath(root), card)), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
