"""Which collectives the gloo backend takes on CUDA tensors, on one card.

    python tools/gloo_cuda_probe.py

Spawns a world of two ranks on ``cuda:0`` over gloo (NCCL refuses two
ranks on one GPU) and a world of one over NCCL, both initialised through
a ``FileStore``, and tries ``all_to_all_single`` (complex64, zero split
sizes for non-partners), ``all_reduce`` (MAX on int64, SUM on float32),
``all_gather_into_tensor`` and ``broadcast`` on CUDA tensors. Then it
times one pairwise exchange of a 256 MiB half block over gloo, both with
the CUDA tensors handed to gloo and staged through pinned host buffers.
Prints one line per check and a JSON summary; exits non-zero if a world
fails.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HALF_ELEMENTS = 1 << 25  # complex64: 256 MiB


def _check(name: str, fn, out: dict):
    try:
        fn()
        out[name] = "ok"
    except Exception as exc:  # a refused collective is the probe's answer
        out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"


def _worker(rank: int, world: int, backend: str, store_path: str,
            result_path: str):
    torch.cuda.set_device(0)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", 0)
    out: dict = {}
    partner = rank ^ 1 if world > 1 else rank

    def a2a():
        send = torch.full((8,), complex(rank, 1), dtype=torch.complex64,
                          device=dev)
        recv = torch.empty_like(send)
        splits = [8 if r == partner else 0 for r in range(world)]
        dist.all_to_all_single(recv, send, splits, splits)
        torch.cuda.synchronize()
        if recv.real[0].item() != partner:
            raise AssertionError(f"received {recv[0].item()}")

    def reduce_max():
        t = torch.tensor([rank + 3], dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        if t.item() != world + 2:
            raise AssertionError(t.item())

    def reduce_sum():
        t = torch.ones(4, dtype=torch.float32, device=dev)
        dist.all_reduce(t)
        if t[0].item() != world:
            raise AssertionError(t[0].item())

    def gather():
        t = torch.full((2,), float(rank), device=dev)
        o = torch.empty(2 * world, device=dev)
        dist.all_gather_into_tensor(o, t)
        if o.tolist() != [float(r) for r in range(world) for _ in range(2)]:
            raise AssertionError(o.tolist())

    def bcast():
        t = torch.full((3,), float(rank + 5), device=dev)
        dist.broadcast(t, 0)
        if t[0].item() != 5.0:
            raise AssertionError(t[0].item())

    for name, fn in (("all_to_all_single", a2a), ("all_reduce_max", reduce_max),
                     ("all_reduce_sum", reduce_sum),
                     ("all_gather_into_tensor", gather), ("broadcast", bcast)):
        _check(name, fn, out)

    if world > 1 and out["all_to_all_single"] == "ok":
        send = torch.randn(HALF_ELEMENTS, dtype=torch.complex64, device=dev)
        recv = torch.empty_like(send)
        splits = [HALF_ELEMENTS if r == partner else 0 for r in range(world)]
        pin_s = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        pin_r = torch.empty_like(pin_s).pin_memory()

        def direct():
            dist.all_to_all_single(recv, send, splits, splits)
            torch.cuda.synchronize()

        def staged():
            pin_s.copy_(send)
            dist.all_to_all_single(pin_r, pin_s, splits, splits)
            recv.copy_(pin_r, non_blocking=True)
            torch.cuda.synchronize()

        for name, fn in (("direct", direct), ("staged", staged)):
            fn()
            dist.barrier()
            t = time.perf_counter()
            for _ in range(3):
                fn()
            out[f"exchange_ms_{name}"] = (time.perf_counter() - t) / 3 * 1e3
    dist.barrier()
    if rank == 0:
        with open(result_path, "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def _world(world: int, backend: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        mp.spawn(_worker, args=(world, backend, os.path.join(tmp, "store"),
                                result), nprocs=world, join=True)
        with open(result) as f:
            return json.load(f)


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    summary = {}
    for world, backend in ((2, "gloo"), (1, "nccl")):
        try:
            summary[f"{backend}_{world}"] = _world(world, backend)
        except Exception:
            traceback.print_exc()
            return 1
        for name, res in summary[f"{backend}_{world}"].items():
            print(f"{backend} world {world}: {name}: {res}", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
