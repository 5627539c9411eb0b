"""One process per rank over `torch.distributed`: the port's counterpart of
the reference's 1-D device mesh (optixpathtracer_tpu/parallel/tiles.py
`make_mesh`).

`run_ranks(fn, world, backend, device, init_file)` starts `world` processes
with the `spawn` method, joins each to one process group (a `file://`
rendezvous: no port to pick, so concurrent runs never collide) and calls
`fn(rank, world, device, *args, **kwargs)` in each. It returns the ranks' results in
rank order, and raises when a rank raises, exits non-zero or outlives its
timeout; it stops every process it started. The caller names the backend
("gloo" or "nccl") and the device ("cpu", "cuda" for `cuda:{rank}`, or one
card such as "cuda:0" for every rank): nothing is chosen for it.

`fn` is pickled by its import path, so it lives in a module of this package
(a child imports the port only), and what it returns is pickled back.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def rank_device(device: str, rank: int) -> torch.device:
    """The device a rank renders on: "cpu", "cuda" -> cuda:{rank}, or the
    one card named ("cuda:0")."""
    if device == "cuda":
        return torch.device("cuda", rank)
    return torch.device(device)


def comm_device(device: torch.device, group=None) -> torch.device:
    """Where a collective's tensors go: the render device under NCCL, the
    host under gloo (gloo reduces CUDA tensors but gathers host tensors
    only, so every gloo collective here is staged through the host)."""
    return device if dist.get_backend(group) == "nccl" else torch.device("cpu")


def _child(fn, rank, world, backend, device, init_method, timeout_s, args, kwargs, out):
    torch.set_num_threads(1)
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, dev, *args, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # report any failure to the parent, then exit non-zero
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, backend: str, device: str, init_file: str, args: tuple = (),
              kwargs: dict | None = None, timeout_s: float = 600.0) -> list:
    """Run `fn(rank, world, torch.device, *args, **kwargs)` on `world`
    spawned ranks joined by `backend`; returns their results in rank order."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if backend == "nccl" and not device.startswith("cuda"):
        raise ValueError("NCCL ranks need CUDA devices")
    if os.path.exists(init_file):
        raise FileExistsError(f"rendezvous file {init_file} exists: give each run a fresh one")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init_method = "file://" + os.path.abspath(init_file)
    procs = [ctx.Process(target=_child, args=(fn, r, world, backend, device, init_method,
                                              timeout_s, args, kwargs or {}, out),
                           daemon=True)
             for r in range(world)]
    results, failures = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        # drain the queue before joining: a child blocks on a full pipe
        while len(results) + len(failures) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} {backend} ranks: no result within {timeout_s} s")
            try:
                rank, ok, value = out.get(timeout=0.5)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    time.sleep(0.5)  # a failing rank's report may still be in flight
                    if out.empty():
                        raise RuntimeError(f"{backend} rank exited with code {dead[0]} "
                                           "before reporting")
                continue
            if ok:
                results[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
                break  # the other ranks would wait on the failed one
        if failures:
            raise RuntimeError(f"{world} {backend} ranks failed:\n" + "\n".join(failures))
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"{backend} rank {procs.index(p)} did not exit")
            if p.exitcode != 0:
                raise RuntimeError(f"{backend} rank {procs.index(p)} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        out.close()
    return [results[r] for r in range(world)]
