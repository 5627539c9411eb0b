#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's eight hand-written CUDA kernels, one nvcc per source,
all started together (optixpathtracer_tpu_torch/csrc/: traverse_cluster.cu
with cull, closest, any, closest_hier and any_hier; worklist.cu with
compact and pair_worklist; gather.cu with gather), and holds each against
its plain PyTorch version on the card, bit for bit. Then it drives the
port's paths and checks that each went through its kernels:

  1. `disney_pt` on the 150k-triangle city at 1200x800, 2 spp, depth 4,
     with the bench's flags: `hier=None` takes the node walk from
     HIER_MIN_ENTRIES = 8 entries, so the city's 74 entries run cull on
     the entry boxes, closest_hier, any_hier (`slice`); the same slice
     through the flat walk (cull on the cluster boxes, closest, any:
     `flat_slice`, with the threshold raised); both walks' frames in turns
     (`city_routes`); both walks' kernels held against their plain versions
     and timed at the city's first bounce and at the engine's second; the
     bench's exactness gate (both walks against the oracle) and the
     `disney_open*` golden renders;
  2. the worklist builders (compact, pair_worklist) on the city's
     first-bounce hit flags and cull words, each one cooperative launch;
  3. the `foveated` preset (sv4) on the city: the published 3840x2160
     configuration (radii 157/515, zone spp 1/2/8) in three launches, as
     PERF.md §4 defines it, then by the preset's own default route (one
     fused launch), held frame for frame against the three launches, and
     the 640x480 fused configuration; its goldens (`foveated_s` against the
     port's CPU render, see `foveated_checks`) and the fused launch against
     the three launches on a 48x32 frame;
  4. the quality pipeline, on the city's node walk: the `sampling=`
     strategies on the card against the CPU (`sobol_card_eq`: Sobol bits,
     `_sobol_pair` and `_ld_bases` bit for bit on 2**20 seeded words and the
     uint32 edges; `sampling_card_vs_cpu`: the open scene per strategy);
     bench.py's quality track at 1200x800 against
     scenes/ref_city_1200x800.npz (`quality_pipeline`: uniform, Sobol +
     adaptive + denoise, progressive foveation, each run to sqrt-space RMSE
     0.03 within its budget, its spp printed beside the JAX record's); the
     sv4 4K configuration with Sobol, Russian roulette and a denoised fovea
     crop (`fovea4k_quality`, 0.03 within 16 frames); `Renderer.aovs`,
     `denoised_image` and a checkpoint round trip (`aov_checkpoint`); one
     profiled Sobol city frame and adaptive refine round with the Sobol
     draws' share (`quality_profile`);
  5. scenes from files and their shading, through the flat walk (cull on
     the cluster boxes, closest, any): bench.py's `--scene loft` row
     (`loft_slice` + `loft_profile`: scenes/loft.obj, three PNG textures,
     `disney_pt` at 1200x800, 2 spp, depth 4 with `scenes.loft_config`),
     the three kernels held against their plain versions and timed at the
     loft's first and second bounce (`loft_kernels`), its exactness gate,
     the texture fetch on the card against the CPU bit for bit and the PNG
     decoder against PIL's channel sums (`texture_card_eq`); the cornell
     box under its parallelogram light at the same size (`cornell_slice`:
     the quad NEE's shadow rays per frame, which `rays_traced` leaves out,
     and K3 twice a bounce); and the `loft*`, `disney_cornell*` and `gltf`
     goldens (`file_goldens`);
  6. the gather probe (gather) on a (1<<20, 128) f32 table;
  7. `disney_pt` on the ~8.68M-triangle terrain-apron scene
     (`build_big_scene` at BIG8X_TERRAIN_GRID, 4239 entries, the node walk:
     cull, closest_hier, any_hier), with the exactness gate against the
     dense oracle, a golden through the node walk, the node kernels' and
     the flat kernels' times on the same rays, and the node cull and sweeps
     again on the slice's second bounce: the rays the engine itself hands
     to its sweeps at depth 1 of a frame (`engine_bounce`).

The cull (K1) is held against its plain version and timed on both tables
(cluster boxes and entry boxes on the city, entry boxes on the big scene)
at the first bounce and at the engine's second; `block_cull` lines time the whole of
`block_cull` / `block_cull_nodes` (pack, kernel, sort, gathers) beside the
kernel alone.

Every kernel timed at the slices' first bounce also gets its bound, the
least time the card could take for the work these inputs need
(`kernel_bound` lines): K1-K4 by FP32 operations, the ray-box slab tests
and ray-triangle pairs `cull_work` / `sweep_work` / `sweep_work_hier` count
times their un-fused op counts (K1: the group tests and the member tests of
the groups that pass, with the count of all ray-box pairs beside it), over
SMs x 128 lanes x the SM clock's maximum; K5a,
K5b and K6 by bytes, inputs read once and outputs written once, over
3.35 TB/s. The node sweeps get both: the bytes are the rays, the node
tables and 9 x C f32 for every member a block must stage, and the larger
time is the bound. K5a, K5b and K6 are also timed against one PyTorch call
that computes the same function (`torch.nonzero`, `torch.nonzero` of the
transposed bit matrix, `index_select`), which the port never calls. K5a
and K5b get device time per call from the profiler (`ms`, the kernels
line's number) and wall time per call with its synchronise (`call_ms`),
for the kernel and `torch.nonzero` alike, beside the launch floor (an empty
kernel, and an empty cooperative wave with one grid barrier), and the
CUDA-event verdict of `in_turns`.

Every phase prints one JSON line with its seconds; any failure exits
non-zero. The `kernels` line gives each kernel's launches on the main
paths, its ms, its plain version's, bound_ms with bound_by, and library_ms
(null where no single PyTorch call computes it). The last line is the
device contract:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
A kernel's `ms`, `plain_ms` and `bound_ms` there are those of the path it
serves first (K1, K4a, K4b: the city's node walk; K2, K3: the flat city
slice); its `paths` give each main path's launches and, where that path's
first bounce was timed (`slice`, `flat_slice`, `loft`, `big_slice`), the
kernel's ms, plain ms and bound there.

It exits non-zero without a CUDA device, and outside the repository (the
port package must be importable beside it).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
RMSE_TOL = 2e-3  # tests/test_goldens.py
PLAIN_BUDGET_S = 60.0  # time a plain version at the slice shape within this
HIER_PLAIN_BUDGET_S = 30.0  # the same for the node walk's plain versions
SLICE_FRAMES = 3  # timed frames of a slice, after one warm-up
TURN_CALLS = 200  # calls of a worklist kernel, its library call and the launch floor per measure
WIDTH, HEIGHT, SPP, DEPTH = 1200, 800, 2, 4
BENCH_FLAGS = dict(sort_rays=True, batch_spp=True, nee_final_bounce=False)
FOV_4K = dict(width=3840, height=2160)  # the sv4 preset's defaults: depth 4, radii 157/515
FOV_FUSED = dict(width=640, height=480)  # bench.py:948-962, interactive size
TPU_FILE = "optixpathtracer_tpu/ops/traverse_cluster.py"
KERNELS = {  # name -> the TPU kernel it replaces
    "cull": f"{TPU_FILE}:226",
    "closest": f"{TPU_FILE}:482",
    "any": f"{TPU_FILE}:622",
    "closest_hier": f"{TPU_FILE}:1289",
    "any_hier": f"{TPU_FILE}:1334",
    "compact": "optixpathtracer_tpu/ops/sc_worklist.py:100",
    "pair_worklist": "optixpathtracer_tpu/ops/sc_worklist.py:190",
    "gather": "experiments/sparsecore_probe.py:87",
}
CSRC = "optixpathtracer_tpu_torch/csrc"
SOURCES = {  # name -> the CUDA source it is built from
    **{k: f"{CSRC}/traverse_cluster.cu" for k in ("cull", "closest", "any", "closest_hier", "any_hier")},
    "compact": f"{CSRC}/worklist.cu",
    "pair_worklist": f"{CSRC}/worklist.cu",
    "gather": f"{CSRC}/gather.cu",
}
LOFT_PNG_SUMS = {  # per-channel sums of PIL's uint8 RGB decode (tests/test_torch_image_io.py checks them)
    "loft_tex0.png": [8298370, 5432022, 3017568],
    "loft_tex1.png": [8546510, 3753297, 2758193],
    "loft_tex2.png": [12670996, 12346164, 11371549],
}
TEXTURE_LOOKUPS = 1 << 20  # `texture_card_eq`'s random texture fetches
FILE_GOLDENS = ("loft_s", "loft", "disney_cornell_s", "disney_cornell", "gltf")
SM_FP32_LANES = 128  # FP32 lanes of one Hopper SM, one un-fused op each per clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
_last_emit = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """One JSON line per phase, with the seconds since the previous line."""
    now = time.perf_counter()
    print(json.dumps({"phase": phase, "phase_s": now - _last_emit[0], **fields}), flush=True)
    _last_emit[0] = now


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def timed(fn):
    """(device milliseconds, result) of one call of fn, without a warm-up."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def fp32_ops_per_s() -> float:
    """The card's FP32 issue rate without FMA (the kernels are built with
    --fmad=false, so every mul and add is one instruction): SMs x 128 lanes
    x the SM clock's maximum as nvidia-smi prints it."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * SM_FP32_LANES * mhz * 1e6


def work_bound(name, work, peak, ms, nbytes=None, **fields):
    """bound_ms of a kernel from its counted work (a SweepWork), with a line
    that shows the count: its operations over the card's rate and, where
    nbytes is given, the bytes it must move over the memory rate; the larger
    of the two is the bound."""
    out = dict(bound_ms=work.ops / peak * 1e3, bound_by="operations")
    both = {}
    if nbytes is not None:
        both = dict(bytes=nbytes, ops_bound_ms=out["bound_ms"],
                    bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        if both["bytes_bound_ms"] > out["bound_ms"]:
            out = dict(bound_ms=both["bytes_bound_ms"], bound_by="bytes")
    emit("kernel_bound", kernel=name, **work._asdict(), ops=work.ops, fp32_ops_per_s=peak,
         ms=ms, **out, **both, share_of_bound=out["bound_ms"] / ms,
         lane_pairs_per_pair=work.lane_pairs / work.pairs if work.pairs else None, **fields)
    return out


def hier_bytes(work, cr, c, any_hit):
    """Bytes a node sweep must move for the work `sweep_work_hier` counted:
    the rays, each visited node's id, key and six box rows, 9 x C f32 per
    member a block stages, and the outputs (t and tri per ray and vis per
    block, or occ per ray)."""
    nr = cr.ids.shape[0]
    rays = cr.rays8.numel() * 4
    out = cr.rays8.shape[0] * 4 if any_hit else cr.rays8.shape[0] * 8 + nr * 4
    return rays + work.nodes * 8 + work.staged_bytes(c) + out


def bytes_bound(nbytes):
    """bound_ms of a kernel that must move nbytes of device memory."""
    return dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes)


def cull_phase(name, rays8, sph_t, grp_t, peak, budget_s, wavefront, card):
    """K1 on one table and one wavefront: its time on all blocks, bit-equality
    with `_cull_torch` on the blocks that fit the budget, and its bound from
    the slab tests this design must do (`cull_work`), with the count of all
    live-ray x box pairs and their bound beside it."""
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    out = time_vs_plain(
        name, lambda nr: tc.cull_blocks(rays8[: nr * tc.BLOCK], sph_t, grp_t),
        lambda nr: tc._cull_torch(rays8[: nr * tc.BLOCK], sph_t), rays8.shape[0] // tc.BLOCK,
        budget_s, wavefront=wavefront, card=card)
    all_pairs = int((rays8[:, 7] > rays8[:, 6]).sum()) * sph_t.shape[1]
    out.update(work_bound(
        name, tc.cull_work(rays8, sph_t, grp_t), peak, out["ms"], wavefront=wavefront, card=card,
        groups=grp_t.shape[1], all_pairs_tests=all_pairs,
        all_pairs_bound_ms=all_pairs * tc.SLAB_OPS / peak * 1e3), library_ms=None)
    return out


def time_hier(cl, cr_c, cr_s, peak, wavefront, card):
    """K4a on cr_c and K4b on cr_s (NodeCullResults of cluster set cl):
    each kernel's time on the whole wavefront, bit-equality with its plain
    version on the blocks that fit HIER_PLAIN_BUDGET_S, K4a's vis against
    the counted visits, and both bounds."""
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    nt, c = cl.node_tables, cl.cluster_size
    out = {}
    for name, crx, any_hit in (("closest_hier", cr_c, False), ("any_hier", cr_s, True)):
        sweep, plain = ((tc.any_hier_sweep, tc._any_hier_torch) if any_hit
                        else (tc.closest_hier_sweep, tc._closest_hier_torch))

        def run(fn, nr):
            got = fn(cl.rows, cl.xf_inv, nt, sub_cull(crx, nr), c)
            return (got,) if any_hit else got[:2]

        nr = crx.ids.shape[0]
        out[name] = time_vs_plain(name, lambda nr: run(sweep, nr), lambda nr: run(plain, nr), nr,
                                  HIER_PLAIN_BUDGET_S, wavefront=wavefront, card=card)
        work = tc.sweep_work_hier(cl.rows, cl.xf_inv, nt, crx, c, any_hit=any_hit)
        if not any_hit:
            vis = int(sweep(cl.rows, cl.xf_inv, nt, crx, c)[2].sum())
            if vis != work.visits:
                raise AssertionError(f"closest_hier ({wavefront}): vis {vis} != {work.visits} counted visits")
        out[name].update(work_bound(
            name, work, peak, out[name]["ms"], nbytes=hier_bytes(work, crx, c, any_hit),
            wavefront=wavefront, card=card, nodes_per_block=work.nodes / nr,
            max_nodes_per_block=int(crx.count.max())), library_ms=None)
    return out


def block_cull_parts(name, cull, cs, rays, tables, wavefront, card):
    """`block_cull` / `block_cull_nodes` whole beside its parts on one
    wavefront: the ray pack, kernel K1 alone, the stable sort with the gather
    of the bit words (and the sort alone), and what is left (the cast of the
    ids, the flat walk's entry index)."""
    import torch

    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    o, d, t_min, t_max = rays
    rays8 = tc._pack_rays8(cs, o, d, t_min, t_max)
    key, lo, hi, _ = tc.cull_blocks(rays8, *tables)
    parts = dict(
        whole_ms=cuda_ms(lambda: cull(cs, o, d, t_min, t_max), reps=5),
        pack_ms=cuda_ms(lambda: tc._pack_rays8(cs, o, d, t_min, t_max), reps=5),
        kernel_ms=cuda_ms(lambda: tc.cull_blocks(rays8, *tables), reps=5),
        sort_gather_ms=cuda_ms(lambda: tc._sort_cull(key, lo, hi), reps=5),
        sort_ms=cuda_ms(lambda: torch.sort(key, dim=1, stable=True), reps=5),
    )
    parts["rest_ms"] = (parts["whole_ms"] - parts["pack_ms"] - parts["kernel_ms"]
                        - parts["sort_gather_ms"])
    emit("block_cull", entry=name, wavefront=wavefront, rays=rays8.shape[0], groups=key.shape[1],
         **parts, card=card)


def in_turns(kern, library, calls):
    """Device ms of kern() and library(), each call between its own events,
    taken in turns (the order swaps every turn) after a warm-up of each:
    median and 10-90 % range of both, and the verdict on the kernel:
    "faster" or "slower" when its median lies outside the library call's
    10-90 % range and the library's median outside the kernel's, else
    "equal within spread"."""
    import torch

    fns = (kern, library)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    spans = ([], [])
    for turn in range(calls):
        for which in ((0, 1) if turn % 2 == 0 else (1, 0)):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[which]()
            e1.record()
            spans[which].append((e0, e1))
    torch.cuda.synchronize()
    stats = []
    for pairs in spans:
        ms = np.asarray([e0.elapsed_time(e1) for e0, e1 in pairs])
        stats.append(dict(median=float(np.median(ms)), p10=float(np.percentile(ms, 10)),
                          p90=float(np.percentile(ms, 90))))
    k, lib = stats
    apart = not (lib["p10"] <= k["median"] <= lib["p90"]) and not (k["p10"] <= lib["median"] <= k["p90"])
    verdict = "equal within spread" if not apart else "faster" if k["median"] < lib["median"] else "slower"
    return dict(calls=calls, ms=k, library_ms=lib, verdict=verdict)


def _device_us(e) -> float:
    """Self device time (us) of a profiler key-average entry."""
    return float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))


def device_per_call(fn, calls):
    """Device microseconds per call of fn: the profiler's device time of
    every kernel and copy that `calls` calls ran (after a warm-up), by name,
    and their sum per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {e.key[:60]: _device_us(e) / calls for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0}
    if not by_name:
        raise AssertionError("the profiler recorded no device time")
    return dict(us=sum(by_name.values()), by_name=by_name)


def wall_per_call(fn, calls):
    """Host microseconds around one call of fn and a synchronise: median and
    10-90 % range over `calls` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    us = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) * 1e6)
    return dict(median=float(np.median(us)), p10=float(np.percentile(us, 10)), p90=float(np.percentile(us, 90)))


def mixed_rays(cs, hs, cam, n, seed, device):
    """bench.py's gate rays: half camera rays, half scene-interior rays."""
    import torch

    from optixpathtracer_tpu_torch.core.math import Vec3

    rng = np.random.default_rng(seed)
    half = n // 2
    uu, vv, ww = cam.uvw_frame()
    sx = rng.uniform(-1, 1, (half, 1))
    sy = rng.uniform(-1, 1, (half, 1))
    dcam = sx * uu[None] + sy * vv[None] + ww[None]
    ocam = np.broadcast_to(np.asarray(cam.eye, np.float32), (half, 3))
    all_v = np.concatenate([m.vertices for m in hs.meshes])
    lo, hi = all_v.min(0), all_v.max(0)
    c, half_ext = (lo + hi) / 2, (hi - lo) / 2
    obnc = c + rng.uniform(-0.85, 0.85, (half, 3)) * half_ext
    dbnc = rng.normal(0, 1, (half, 3))
    og = np.concatenate([ocam, obnc]).astype(np.float32)
    dg = np.concatenate([dcam, dbnc]).astype(np.float32)
    dg /= np.linalg.norm(dg, axis=1, keepdims=True)

    def v3(a):
        return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]), device=device) for i in range(3)))

    return v3(og), v3(dg)


def sub_cull(cr, nr):
    """The first nr ray blocks of a CullResult or NodeCullResult."""
    from optixpathtracer_tpu_torch.ops.traverse_cluster import BLOCK

    return cr._replace(**{k: getattr(cr, k)[:nr] for k in cr._fields if k != "rays8"},
                       rays8=cr.rays8[: nr * BLOCK])


def compare(name, kernel_out, plain_out):
    """max |kernel - plain| over a kernel's outputs; raises unless bit-equal."""
    import torch

    err = 0.0
    for k, p in zip(kernel_out, plain_out):
        if k is None or p is None:
            continue
        if not torch.equal(k, p):
            bad = int((k != p).sum())
            raise AssertionError(f"{name}: kernel differs from its plain version in {bad} values")
        err = max(err, float((k.double() - p.double()).abs().max()) if k.numel() else 0.0)
    return err


def check_vs_plain(name, kern, plain, nr_full, budget_s):
    """Hold kern(nr) bit for bit against plain(nr) on the first nr ray blocks,
    nr cut so that the plain version runs within about budget_s (estimated
    from a run on 1/32 of the blocks). kern/plain map a block count to a
    tuple of outputs. Returns (plain ms, nr, max_abs_err)."""
    probe_nr = min(nr_full, max(8, nr_full // 32))
    probe_ms, out_p = timed(lambda: plain(probe_nr))
    est_s = probe_ms / 1e3 * nr_full / probe_nr
    nr = nr_full if est_s <= budget_s else max(probe_nr, int(nr_full * budget_s / est_s))
    plain_ms = probe_ms
    if nr != probe_nr:
        plain_ms, out_p = timed(lambda: plain(nr))
    return plain_ms, nr, compare(name, kern(nr), out_p)


def time_vs_plain(name, kern, plain, nr_full, budget_s, **fields):
    """Kernel ms on all nr_full blocks (mean of 5), then `check_vs_plain`."""
    from optixpathtracer_tpu_torch.ops.traverse_cluster import BLOCK

    ms = cuda_ms(lambda: kern(nr_full), reps=5)
    plain_ms, nr, err = check_vs_plain(name, kern, plain, nr_full, budget_s)
    out = dict(ms=ms, plain_ms=plain_ms, rays=nr_full * BLOCK, plain_rays=nr * BLOCK,
               max_abs_err=err)
    emit("kernel_time", kernel=name, **out, **fields)
    return out


def time_flat(cl, rays8, cr, cr_s, peak, wavefront, card):
    """The flat walk's kernels on one wavefront of cluster set cl: K1 on the
    cluster boxes (rays8), K2 on cr (the CullResult of those rays) and K3 on
    cr_s (that of their shadow rays). Each kernel's time on all blocks,
    bit-equality with its plain version on the blocks that fit
    PLAIN_BUDGET_S, and its bound from the work these inputs need."""
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    c = cl.cluster_size
    out = {"cull": cull_phase("cull", rays8, *cl.cull_tables, peak, PLAIN_BUDGET_S, wavefront, card)}
    cases = {
        "closest": (cr, lambda nr: tc.closest_sweep(cl.rows, cl.xf_inv, sub_cull(cr, nr), c)[:2],
                    lambda nr: tc._closest_torch(cl.rows, cl.xf_inv, sub_cull(cr, nr), c)),
        "any": (cr_s, lambda nr: (tc.any_sweep(cl.rows, cl.xf_inv, sub_cull(cr_s, nr), c),),
                lambda nr: (tc._any_torch(cl.rows, cl.xf_inv, sub_cull(cr_s, nr), c),)),
    }
    for name, (crx, kern, plain) in cases.items():
        out[name] = time_vs_plain(name, kern, plain, crx.ids.shape[0], PLAIN_BUDGET_S,
                                  wavefront=wavefront, card=card)
        work = tc.sweep_work(cl.rows, cl.xf_inv, crx, c, any_hit=name == "any")
        out[name].update(work_bound(name, work, peak, out[name]["ms"], wavefront=wavefront, card=card),
                         library_ms=None)
    return out


def exactness_gate(phase, cs, hs, cam, dev, n=8192):
    """bench.py:1302-1340: the winning triangle of n mixed rays (`mixed_rays`,
    seed 42) through the scene's own walk (hier=None) and through the other
    walk, each equal to `reference_closest`'s; raises on any mismatch."""
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    cl = cs.clusters
    og, dg = mixed_rays(cs, hs, cam, n, 42, dev)
    fast = tc.closest_hit_cluster(cl, og, dg, 1e-3, 1e16)
    other = tc.closest_hit_cluster(cl, og, dg, 1e-3, 1e16, hier=walk_of(cl) == "flat")
    exact = tc.reference_closest(cl, og, dg, 1e-3, 1e16)
    mismatch = int((fast.tri != exact.tri).sum())
    walk_mismatch = int((fast.tri != other.tri).sum())
    emit(phase, rays=n, walk=walk_of(cl), entries=cl.num_entries, mismatch=mismatch,
         flat_vs_hier_mismatch=walk_mismatch, hits=int((exact.tri >= 0).sum()))
    if mismatch or walk_mismatch:
        raise AssertionError(f"{phase}: {mismatch} rays disagree with reference_closest, "
                             f"{walk_mismatch} between the two walks")


def first_bounce_and_shadows(renderer, cl, probe, dev):
    """The slice's first-bounce wavefront, coherence-sorted as the engine
    sorts it, its NEE shadow rays, sorted the same way, and its hit flags:
    ((o, d), (p_hit, wi, t_sh), hit)."""
    import torch

    from optixpathtracer_tpu_torch.core.math import Vec3
    from optixpathtracer_tpu_torch.core.rng import RngState, tea
    from optixpathtracer_tpu_torch.engine import wavefront
    from optixpathtracer_tpu_torch.lights.probe import probe_sample
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    cfg = renderer.config
    cam_p = wavefront.CameraParams.from_camera(renderer.camera, dev)
    o1, d1 = wavefront.first_bounce_rays(cfg, cam_p, *renderer.pixels)
    n1 = o1.x.shape[0]
    no = torch.zeros(n1, dtype=torch.bool, device=dev)
    perm = wavefront._stable_argsort(wavefront._coherence_key(o1, d1, no, cl.scene_aabb))
    o1, d1 = Vec3(*(a[perm] for a in o1)), Vec3(*(a[perm] for a in d1))
    rec = tc.closest_hit_cluster(cl, o1, d1, cfg.t_min, cfg.t_max)
    p_hit = o1 + d1 * rec.t
    _, wi, _, _ = probe_sample(probe, RngState.seed(tea(torch.arange(n1, device=dev), 7)))
    t_sh = torch.where(rec.hit, cfg.t_max, 0.0)
    perm = wavefront._stable_argsort(
        wavefront._coherence_key(p_hit, wi, t_sh <= cfg.shadow_t_min, cl.scene_aabb))
    hit = rec.hit
    p_hit, wi, t_sh = Vec3(*(a[perm] for a in p_hit)), Vec3(*(a[perm] for a in wi)), t_sh[perm]
    return (o1, d1), (p_hit, wi, t_sh), hit


def frame_calls(renderer, names):
    """(args, result) of every call of the `engine/wavefront` functions
    `names` in one more frame of renderer: the frame is rendered with those
    functions wrapped to record their calls, and the renderer's
    accumulation is put back afterwards."""
    from optixpathtracer_tpu_torch.engine import wavefront

    real = {name: getattr(wavefront, name) for name in names}
    calls = {name: [] for name in names}

    def recording(name):
        def call(*args, **kw):
            out = real[name](*args, **kw)
            calls[name].append((args, out))
            return out
        return call

    state = (renderer.accum, renderer.subframe_index)
    for name in names:
        setattr(wavefront, name, recording(name))
    try:
        renderer.render(download=False)
    finally:
        for name, fn in real.items():
            setattr(wavefront, name, fn)
        renderer.accum, renderer.subframe_index = state
    return calls


def engine_bounce(renderer, depth):
    """The rays the engine hands to its sweeps at bounce `depth` of one frame
    of `renderer`: ((o, d, t_min, t_max) of `closest_hit_cluster`, the same
    of its probe NEE's `any_hit_cluster`), coherence-sorted and with dead
    lanes closed (t_max 0) as `trace_wavefront` passes them."""
    calls = frame_calls(renderer, ("closest_hit_cluster", "any_hit_cluster"))
    return tuple(tuple(calls[name][depth][0][1:5]) for name in ("closest_hit_cluster", "any_hit_cluster"))


def time_frames(renderer, frames):
    """Seconds of `frames` frames after one warm-up; each ends in a
    device synchronise (`render(download=False)`)."""
    renderer.render(download=False)  # warm-up
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        renderer.render(download=False)
        times.append(time.perf_counter() - t0)
    return times


def drive_slice(phase, renderer, card, counts, flags=BENCH_FLAGS, **fields):
    """The main path: one warm-up frame and 3 timed frames, with the kernel
    launch counts set to 0 just before and read just after. Works for the
    `Renderer` and the `FoveatedRenderer` alike."""
    import torch

    cfg = renderer.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.clear()
    times = time_frames(renderer, SLICE_FRAMES)
    rays = int(renderer.last_rays if hasattr(renderer, "last_rays") else renderer.last_output.rays_traced)
    launches = dict(counts)
    img = renderer.accum_image()
    frame_s = float(np.median(times))
    emit(phase, width=cfg.width, height=cfg.height, max_depth=cfg.max_depth, flags=flags,
         **fields,
         frame_s=frame_s, frame_times_s=times, frame_s_range=[min(times), max(times)], rays_traced=rays,
         mrays_per_s=rays / frame_s / 1e6, max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, launches_per_frame={k: v / (SLICE_FRAMES + 1) for k, v in launches.items()},
         image_mean=float(img.mean()), card=card)
    if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError(f"{phase}: the frame is not a finite, non-black "
                             f"{cfg.width}x{cfg.height} image")
    return launches


WALK_KERNELS = {"node": ("cull", "closest_hier", "any_hier"), "flat": ("cull", "closest", "any")}


def walk_of(cl):
    """The walk `hier=None` takes on a cluster set: "node" or "flat"."""
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    return "node" if cl.num_entries >= tc.HIER_MIN_ENTRIES else "flat"


@contextlib.contextmanager
def walk(name):
    """Route `hier=None` through one walk ("node" or "flat") by moving
    `HIER_MIN_ENTRIES`, and put it back afterwards."""
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    saved = tc.HIER_MIN_ENTRIES
    tc.HIER_MIN_ENTRIES = 0 if name == "node" else 1 << 30
    try:
        yield
    finally:
        tc.HIER_MIN_ENTRIES = saved


def check_walk(path, launches, name):
    """Raise unless a path launched every kernel of its walk and neither
    sweep of the other."""
    other = "flat" if name == "node" else "node"
    for k in WALK_KERNELS[name]:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{path} never launched kernel {k}")
    for k in WALK_KERNELS[other][1:]:
        if launches.get(k, 0):
            raise AssertionError(f"{path} launched kernel {k} of the {other} walk")


def route_turns(renderer, counts, frames=3):
    """Frame seconds of one renderer through the node walk and through the
    flat walk, in turns (node, flat, flat, node): one warm-up and `frames`
    timed frames each, with each turn's launches and peak device memory."""
    import torch

    turns = []
    for route in ("node", "flat", "flat", "node"):
        with walk(route):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts.clear()
            times = time_frames(renderer, frames)
        turns.append(dict(route=route, frame_s=float(np.median(times)), frame_times_s=times,
                          rays=int(renderer.last_output.rays_traced), launches=dict(counts),
                          max_memory_allocated=torch.cuda.max_memory_allocated()))
    med = {k: float(np.median([t["frame_s"] for t in turns if t["route"] == k])) for k in ("node", "flat")}
    return dict(turns=turns, node_s=med["node"], flat_s=med["flat"], node_wins=med["node"] < med["flat"])


def profile_frame(phase, renderer):
    """One more frame under the profiler (not timed above): device busy time
    by kernel, and the device's idle share of the frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render(download=False)
        wall = time.perf_counter() - t0
    # device-side entries only: the CPU-side op entries repeat their kernels'
    # device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6
    if busy <= 0:
        raise AssertionError(f"{phase}: the profiler recorded no device time: no idle share")
    top = sorted(events, key=_device_us, reverse=True)[:15]
    emit(phase, wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
         top=[{"name": e.key[:80], "ms": _device_us(e) / 1e3, "calls": e.count} for e in top])


def worklist_vs_plain(hit, cull_lo, card):
    """K5a on the first bounce's hit flags and K5b on its cull words, each
    at a capacity above its count and one below: the entry points' launches
    (counted), then bit-equality with the plain versions, the plain
    version's time, and the kernel beside its one PyTorch call and the
    launch floor (an empty kernel, and an empty cooperative wave with one
    grid barrier, `sc_worklist.empty_launch`): device time per call from the
    profiler (`device_per_call`, TURN_CALLS calls: `ms`, `library_ms`) and
    wall time per call with its synchronise (`wall_per_call`: `call_ms`,
    `library_call_ms`), plus the CUDA-event verdict of `in_turns`
    (`vs_library`). Returns ({name: launches}, {name: timing})."""
    import torch

    from optixpathtracer_tpu_torch.ops import sc_worklist as sw

    flags = hit.contiguous()
    words = cull_lo.reshape(-1).contiguous()
    n_set = int(flags.sum())
    n_bits = int(sum(int(torch.bitwise_and(words >> b, 1).sum()) for b in range(32)))
    cases = {
        "compact": (sw.compact_indices, sw.compact_indices_torch, flags, n_set),
        "pair_worklist": (sw.pair_worklist, sw.pair_worklist_torch, words, n_bits),
    }
    caps = {name: (count + 1000, max(1, count // 2)) for name, (_, _, _, count) in cases.items()}
    # one PyTorch call for each, timed beside the kernel and used nowhere else
    bit_matrix = ((words.to(torch.int64)[None, :] >> torch.arange(32, device=words.device)[:, None]) & 1) != 0
    library = {"compact": lambda: torch.nonzero(flags), "pair_worklist": lambda: torch.nonzero(bit_matrix)}
    sw.launch_counts.clear()
    outs = {name: [kern(x, cap) for cap in caps[name]] for name, (kern, _, x, _) in cases.items()}
    torch.cuda.synchronize()
    launches = dict(sw.launch_counts)
    floor = {}
    for kind, cooperative in (("empty", False), ("empty_cooperative", True)):
        floor[kind] = dict(
            device_us=device_per_call(lambda: sw.empty_launch(flags.device, cooperative), TURN_CALLS)["us"],
            call_us=wall_per_call(lambda: sw.empty_launch(flags.device, cooperative), TURN_CALLS)["median"])
    emit("launch_floor", **floor, calls=TURN_CALLS, card=card)
    timing = {}
    for name, (kern, plain, x, count) in cases.items():
        err = 0.0
        for cap, got in zip(caps[name], outs[name]):
            err = max(err, compare(f"{name} (capacity {cap})", got, plain(x, cap)))
            if int(got[-1]) != count:
                raise AssertionError(f"{name}: count {int(got[-1])}, expected {count}")
        cap = caps[name][0]
        # input read once, outputs written once: flags (1 B) or words (4 B),
        # then capacity int32 indices (K5b: rows and columns) and the count
        nbytes = x.numel() * x.element_size() + cap * 4 * (1 if name == "compact" else 2) + 4
        dev_k = device_per_call(lambda: kern(x, cap), TURN_CALLS)
        dev_l = device_per_call(library[name], TURN_CALLS)
        wall_k = wall_per_call(lambda: kern(x, cap), TURN_CALLS)
        wall_l = wall_per_call(library[name], TURN_CALLS)
        timing[name] = dict(ms=dev_k["us"] / 1e3, call_ms=wall_k["median"] / 1e3,
                            library_ms=dev_l["us"] / 1e3, library_call_ms=wall_l["median"] / 1e3,
                            plain_ms=cuda_ms(lambda: plain(x, cap), reps=5), max_abs_err=err,
                            **bytes_bound(nbytes))
        emit("worklist_vs_plain", kernel=name, input=("first-bounce hit flags" if name == "compact"
                                                      else "first-bounce cull lo words"),
             n=x.shape[0], count=count, capacities=list(caps[name]), bit_equal=True,
             launches=launches.get(name, 0), **timing[name], share_of_bound=timing[name]["bound_ms"] / timing[name]["ms"],
             device_us_by_name=dev_k["by_name"], library_device_us_by_name=dev_l["by_name"],
             call_us_10_90=[wall_k["p10"], wall_k["p90"]], library_call_us_10_90=[wall_l["p10"], wall_l["p90"]],
             launch_floor=floor, vs_library=in_turns(lambda: kern(x, cap), library[name], calls=TURN_CALLS),
             card=card)
    return launches, timing


def gather_probe_phase(dev, card):
    """K6 through the gather probe's entry point (counted), then bit-equal
    to index_select on the probe's 1M indices, and its time at 1M."""
    import torch

    from optixpathtracer_tpu_torch.experiments import gather_probe
    from optixpathtracer_tpu_torch.ops import gather

    gather.launch_counts.clear()
    rates = gather_probe.measure(dev)
    launches = dict(gather.launch_counts)
    table = gather_probe.probe_table(dev)
    idx = gather_probe.probe_indices(dev, gather_probe.SIZES["1m"])
    err = compare("gather", (gather.gather_rows(table, idx),), (gather.gather_rows_torch(table, idx),))
    # indices and the distinct rows they name read once, the rows written once
    width = table.shape[1] * table.element_size()
    nbytes = idx.numel() * 4 + int(torch.unique(idx).numel()) * width + idx.numel() * width
    timing = dict(ms=cuda_ms(lambda: gather.gather_rows(table, idx), reps=5),
                  plain_ms=cuda_ms(lambda: gather.gather_rows_torch(table, idx), reps=5),
                  library_ms=cuda_ms(lambda: torch.index_select(table, 0, idx), reps=5),
                  max_abs_err=err, **bytes_bound(nbytes))
    emit("gather_probe", table=[gather_probe.N_ROWS, gather_probe.ROW_WIDTH], bit_equal=True,
         launches=launches.get("gather", 0), **rates, **timing, card=card)
    del table, idx
    return launches, timing


def foveated_checks(dev):
    """The `foveated*` goldens on the card, and the fused launch against the
    three launches on tests/test_foveated_fused.py's 48x32 setup.

    `foveated` must hold its golden. `foveated_s` is held against the
    port's own render of it on the CPU (its plain versions): the golden was
    rendered by jitted JAX, which fuses a*b+c into FMAs, and one fovea
    sample of it takes another path there than in the eager JAX renderer
    (and in the port, which rounds every op), which puts both at RMSE
    2.38e-3 (tests/test_torch_foveated.py)."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.camera import Camera
    from optixpathtracer_tpu_torch.core.materials import make_material
    from optixpathtracer_tpu_torch.core.scene import HostScene
    from optixpathtracer_tpu_torch.engine.foveated import FoveatedRenderer, FoveationConfig
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
    from optixpathtracer_tpu_torch.lights.probe import build_probe

    for name in scenes.FOVEATED_GOLDENS:
        got = scenes.render_foveated_golden(name, dev)
        want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
        rmse = scenes.golden_rmse(got, want)
        fields = dict(name=name, rmse=rmse, tol=RMSE_TOL)
        if name == "foveated_s":
            want = scenes.render_foveated_golden(name, torch.device("cpu"))
            fields.update(rmse_vs_cpu_port=scenes.golden_rmse(got, want))
        emit("foveated_golden", **fields)
        if not (got.shape == want.shape and scenes.golden_rmse(got, want) <= RMSE_TOL):
            raise AssertionError(f"foveated golden {name}: {fields}")

    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs, dev)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32), dev)
    cfg = RenderConfig(width=48, height=32, max_depth=1, antialias=False, batch_spp=True,
                       traversal="cluster")
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=48 / 32)
    imgs, rays = [], []
    for fused in (False, True):
        r = FoveatedRenderer(cs, probe, cfg, cam, FoveationConfig(inner_radius=8, outer_radius=16),
                             fused=fused)
        r.set_gaze(24, 16)
        r.render(download=False)
        imgs.append(r.accum_image())
        rays.append(r.last_rays)
    diff = float(np.abs(imgs[1] - imgs[0]).max())
    emit("fov_fused_eq", max_abs_diff=diff, tol=1e-5, rays=rays)
    if not (np.allclose(imgs[1], imgs[0], rtol=1e-5, atol=1e-5) and rays[0] == rays[1]):
        raise AssertionError(f"fused foveation differs from three launches: {diff}, rays {rays}")


def zone_lanes(renderer):
    """Lanes per zone of a FoveatedRenderer's frame: launched, live, traced
    (live x spp)."""
    from optixpathtracer_tpu_torch.engine.foveated import _zone_pixels

    gaze = (renderer.gaze[0], renderer.config.height - 1 - renderer.gaze[1])
    out = {}
    for z in renderer.zones:
        _, _, active = _zone_pixels(renderer.config, z, gaze, renderer.device)
        live = int(active.sum())
        out[z.name] = dict(factor=z.factor, spp=z.spp, lanes=int(active.numel()), live=live,
                           sample_lanes=live * z.spp)
    return out


QUALITY_TARGET = 0.03  # sqrt-space RMSE the bench's quality rows run to (bench.py:508)
JAX_RECORD = {  # BENCH_LOCAL_r5.json: the JAX package's rows (spp are the estimator's, not the chip's)
    "uniform": dict(spp=50), "pipeline": dict(spp=2.0), "foveated": dict(spp=56),
    "fovea4k": dict(frames=1, fovea_spp=8, rmse_denoised=0.01722, companion_rmse_q=0.18721),
}
SAMPLING_TOL = 1e-5  # card against the port's CPU render, sqrt-space RMSE


def sobol_card_eq(dev, card):
    """`core/sobol.sobol02_bits`, `_sobol_pair` and `_ld_bases` (stratified,
    blue) on the card against the port's CPU results, bit for bit, on 2**20
    seeded uint32 inputs and the edges 0, 1, 2**31 - 1, 2**31, 2**32 - 1."""
    import torch

    from optixpathtracer_tpu_torch.core import sobol
    from optixpathtracer_tpu_torch.engine import wavefront as wf

    rng = np.random.default_rng(8)
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.int64)
    words = []
    for _ in range(4):
        w = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.int64)
        w[:edges.size] = edges
        words.append(torch.as_tensor(w))
    mism = {}

    def check(name, fn, *args):
        want = fn(*args)
        got = fn(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args))
        bad = 0
        for g, w in zip(got, want):
            if not isinstance(g, torch.Tensor):
                bad += int(g != w)
                continue
            g = g.cpu()
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            bad += int((g != w).sum())
        mism[name] = bad

    check("sobol02_bits", sobol.sobol02_bits, *words)
    check("sobol02_point", sobol.sobol02_point, *words)
    pix, ctr = words[0] % (WIDTH * HEIGHT), words[1]
    for depth in (0, 3):
        for salt in (wf._LD_SALT_AA, wf._LD_SALT_NEE, wf._LD_SALT_BSDF):
            check(f"_sobol_pair depth {depth} salt {salt:#x}", wf._sobol_pair, pix, ctr, depth, salt)
    for sampling, m in (("stratified", 9), ("stratified", 64), ("blue", 16)):
        cfg = wf.RenderConfig(sampling=sampling, sampling_strata=m)
        for salt in (wf._LD_SALT_AA, wf._LD_SALT_NEE):
            check(f"_ld_bases {sampling} m={m} salt {salt:#x}", wf._ld_bases, cfg, pix, ctr, salt)
    emit("sobol_card_eq", inputs=1 << 20, edges=edges.tolist(), mismatches=mism, card=card)
    if any(mism.values()):
        raise AssertionError(f"sobol_card_eq: the card differs from the CPU: {mism}")


def sampling_card_vs_cpu(dev, card):
    """The open golden scene (96x64, 2 spp, depth 2, the bench's flags) per
    strategy, on the card and through the port on the CPU; both run the
    same code, so they agree to SAMPLING_TOL in sqrt space."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.engine.renderer import Renderer
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig

    w, h = 96, 64
    rmse = {}
    for sampling in ("stratified", "blue", "sobol"):
        imgs = []
        for d in (dev, torch.device("cpu")):
            cfg = RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=2,
                               traversal="cluster", sampling=sampling, sampling_strata=16,
                               **BENCH_FLAGS)
            r = Renderer(compile_scene(scenes.open_scene(), d), scenes.sky_probe(d), cfg,
                         scenes.open_camera(w, h))
            r.render_n(2)
            imgs.append(r.accum_image())
        rmse[sampling] = scenes.golden_rmse(*imgs)
        if not (np.isfinite(imgs[0]).all() and imgs[0].max() > 0):
            raise AssertionError(f"sampling_card_vs_cpu: {sampling} rendered no finite image")
    emit("sampling_card_vs_cpu", width=w, height=h, spp=2, max_depth=2, frames=2,
         rmse_vs_cpu_port=rmse, tol=SAMPLING_TOL, card=card)
    if max(rmse.values()) > SAMPLING_TOL:
        raise AssertionError(f"sampling_card_vs_cpu: {rmse} above {SAMPLING_TOL}")


def _sqrt_img(a):
    import torch

    return torch.sqrt(torch.clamp(a, min=0.0))


def _rmse(a, b) -> float:
    """sqrt-space RMSE of two device tensors, one scalar to the host."""
    import torch

    return float(torch.sqrt(torch.mean((_sqrt_img(a) - b) ** 2)))


def _row(name, label, run, card, **fields):
    """Run a quality row to QUALITY_TARGET: run() yields (seconds so far,
    rmse, spp) per checkpoint; returns the row, emitted."""
    secs = spp = None
    rmse = float("inf")
    checkpoints = 0
    for t, v, s in run:
        rmse, checkpoints, spp_last = v, checkpoints + 1, s
        if v <= QUALITY_TARGET:
            secs, spp = t, s
            break
    rec = dict(row=name, label=label, reached=secs is not None, seconds=secs, spp=spp,
               final_rmse=rmse, checkpoints=checkpoints, last_spp=spp_last,
               jax_record=JAX_RECORD[name], target=QUALITY_TARGET, **fields, card=card)
    emit("quality_pipeline", **rec)
    return rec


def quality_pipeline(cs, probe, dev, counts, card):
    """bench.py:508-737 at 1200x800 against scenes/ref_city_1200x800.npz: a
    uniform progressive row (random sampling, 2 spp a launch, at most 64
    launches), the pipeline row (AdaptiveRenderer with Sobol, warm-up 2,
    refine 4 over a quarter of the tiles, the bench's denoise, at most 24
    rounds) and a progressive foveated row (radii 80/200, centre gaze,
    fovea-disc RMSE, at most 40 frames, the port's default route). Every
    RMSE is computed on the device, one scalar per checkpoint; every row
    must reach QUALITY_TARGET. Returns {path: launches}."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.engine.adaptive import AdaptiveRenderer
    from optixpathtracer_tpu_torch.engine.foveated import FoveationConfig
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer, make_foveated_renderer

    ref_d = np.load(os.path.join(REPO, "scenes", "ref_city_1200x800.npz"))
    w, h = int(ref_d["width"]), int(ref_d["height"])
    ref_sqrt = _sqrt_img(torch.as_tensor(ref_d["image"].astype(np.float32), device=dev))  # canonical
    cam = scenes.city_camera(w, h)
    runs, rows = {}, {}

    # ---- uniform progressive PT, random sampling ---------------------------
    r = make_disney_pt_renderer(cs, probe, cam, width=w, height=h, spp=2, max_depth=4, **BENCH_FLAGS)
    ref_tile = ref_sqrt[torch.as_tensor(r._perm, device=dev)]

    def run_uniform():
        r.render(download=False)  # warm-up, then a fresh accumulation
        r.resize(w, h)
        counts.clear()
        t = 0.0
        for i in range(64):
            t0 = time.perf_counter()
            r.render(download=False)
            v = _rmse(torch.stack(list(r.accum), -1), ref_tile)
            t += time.perf_counter() - t0
            yield t, v, (i + 1) * r.config.samples_per_launch

    rows["uniform"] = _row("uniform", "uniform PT, random sampling", run_uniform(), card,
                           ref_spp=int(ref_d["spp"]))
    runs["quality_uniform"] = dict(counts)
    del r, ref_tile

    # ---- Sobol + adaptive + denoise ----------------------------------------
    acfg = RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=4, traversal="cluster",
                        sampling="sobol", **BENCH_FLAGS)
    ref_img = ref_sqrt.reshape(h, w, 3).flip(0)  # top row first, as the renderer's images

    def make_adaptive():
        return AdaptiveRenderer(cs, probe, acfg, cam, warmup_spp=2, refine_spp=4, refine_fraction=0.25)

    def run_pipeline():
        warm = make_adaptive()  # warm both launch shapes (warm-up and refine)
        for _ in range(2):
            warm.render()
            _rmse(warm.denoised_tensor(), ref_img)
        del warm
        ar = make_adaptive()
        counts.clear()
        t = 0.0
        for _ in range(24):
            t0 = time.perf_counter()
            ar.render()
            v = _rmse(ar.denoised_tensor(), ref_img)
            t += time.perf_counter() - t0
            yield t, v, float(ar.count.sum()) / (w * h)

    rows["pipeline"] = _row("pipeline", "sobol+adaptive+denoise", run_pipeline(), card,
                            ref_spp=int(ref_d["spp"]))
    runs["quality_pipeline"] = dict(counts)

    # ---- progressive foveation, fovea-disc RMSE ----------------------------
    fcfg = FoveationConfig(inner_radius=80, outer_radius=200, progressive=True)
    gx, gy = w // 2, h // 2  # the frame's centre: the y flip does not move it
    ii = torch.arange(w * h, device=dev)
    disc = ((ii % w - gx) ** 2 + (ii // w - gy) ** 2) <= 80 ** 2
    ref_disc = ref_sqrt[disc]

    def make_fov():
        fr = make_foveated_renderer(cs, probe, cam, width=w, height=h, max_depth=4, foveation=fcfg,
                                    samples_per_launch=1, sampling="sobol", **BENCH_FLAGS)
        fr.set_gaze(gx, gy)
        return fr

    def run_fovea():
        make_fov().render(download=False)  # warm-up
        fr = make_fov()
        counts.clear()
        t = 0.0
        for i in range(40):
            t0 = time.perf_counter()
            fr.render(download=False)
            v = _rmse(torch.stack(list(fr.accum), -1)[disc], ref_disc)
            t += time.perf_counter() - t0
            yield t, v, (i + 1) * fcfg.fovea_spp

    rows["foveated"] = _row("foveated", "progressive foveation, fovea disc", run_fovea(), card,
                            fused=make_fov().fused, foveation=dataclasses.asdict(fcfg),
                            ref_spp=int(ref_d["spp"]))
    runs["quality_foveated"] = dict(counts)
    failed = [k for k, v in rows.items() if not v["reached"]]
    if failed:
        raise AssertionError(f"quality_pipeline: rows {failed} did not reach RMSE {QUALITY_TARGET}")
    return runs


def fovea4k_quality(cs, probe, dev, counts, card):
    """bench.py:740-913 at the published sv4 configuration: 3840x2160,
    radii 157/515, zone spp 1/2/8, progressive, Sobol, Russian roulette, the
    bench's flags, the port's default route (fused), the gaze of
    scenes/ref_city_4k_fovea.npz; the 384x384 fovea crop is denoised with
    first-hit guides (one primary-visibility pass through
    `closest_hit_cluster` + `_hit_geometry`). Fails unless min(raw,
    denoised) disc RMSE reaches QUALITY_TARGET within 16 frames. Returns
    {path: launches}."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.core.math import Vec3
    from optixpathtracer_tpu_torch.engine.foveated import FoveationConfig
    from optixpathtracer_tpu_torch.engine.wavefront import _hit_geometry
    from optixpathtracer_tpu_torch.models import make_foveated_renderer
    from optixpathtracer_tpu_torch.ops.denoise import atrous_denoise
    from optixpathtracer_tpu_torch.ops.traverse_cluster import closest_hit_cluster

    fd = np.load(os.path.join(REPO, "scenes", "ref_city_4k_fovea.npz"))
    qd = np.load(os.path.join(REPO, "scenes", "ref_city_4k_q.npz"))
    w, h = int(fd["width"]), int(fd["height"])
    cx, cy = (int(v) for v in fd["gaze"])  # buffer coordinates, bottom row first
    idx = torch.as_tensor(fd["idx"].astype(np.int64), device=dev)
    ref_disc = _sqrt_img(torch.as_tensor(fd["image"].astype(np.float32), device=dev))
    ref_q = _sqrt_img(torch.as_tensor(qd["image"].astype(np.float32), device=dev))
    cam = scenes.city_camera(w, h)
    fov = FoveationConfig(inner_radius=157, outer_radius=515, progressive=True)
    fr = make_foveated_renderer(cs, probe, cam, width=w, height=h, max_depth=4, foveation=fov,
                                samples_per_launch=1, sampling="sobol", russian_roulette=True,
                                **BENCH_FLAGS)
    fr.set_gaze(cx, h - 1 - cy)  # image coordinates: the splat centre is the disc's centre

    half = 192  # the fovea crop, 384x384 around the gaze; the r=157 disc lies inside
    r0, c0 = cy - half, cx - half
    disc_rows, disc_cols = idx // w - r0, idx % w - c0
    ys, xs = np.mgrid[r0:r0 + 2 * half, c0:c0 + 2 * half]
    uu, vv, ww = cam.uvw_frame()
    dirs = ((2.0 * (xs.ravel() + 0.5) / w - 1.0)[:, None] * uu[None]
            + (2.0 * (ys.ravel() + 0.5) / h - 1.0)[:, None] * vv[None] + ww[None])
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    d3 = Vec3(*(torch.as_tensor(np.ascontiguousarray(dirs[:, i]), device=dev) for i in range(3)))
    o3 = Vec3(*(torch.full_like(d3.x, float(c)) for c in np.asarray(cam.eye, np.float32)))
    rec = closest_hit_cluster(cs.clusters, o3, d3, 1e-3, 1e16)
    nrm, _, alb = _hit_geometry(cs, rec, d3, False)
    hit = rec.t < 1e15
    g_nrm, g_alb = (torch.stack([torch.where(hit, c, 0.0) for c in v], -1).reshape(2 * half, 2 * half, 3)
                    for v in (nrm, alb))
    g_z = torch.where(hit, rec.t, 0.0).reshape(2 * half, 2 * half)

    def rmses():
        img = torch.stack(list(fr.accum), -1)  # (W*H, 3), canonical
        raw = _rmse(img[idx], ref_disc)
        crop = img.reshape(h, w, 3)[r0:r0 + 2 * half, c0:c0 + 2 * half]
        dn = atrous_denoise(crop, g_nrm, g_alb, sigma_color=4.0, sigma_albedo=1.0, depth=g_z,
                            demodulate=True)
        return raw, _rmse(dn[disc_rows, disc_cols], ref_disc)

    fr.render(download=False)  # warm-up, then a fresh accumulation
    rmses()
    fr.accum = Vec3.zeros((w * h,), dev)
    fr.subframe_index = 0
    counts.clear()
    t = 0.0
    secs = frames = None
    raw = den = float("inf")
    for i in range(16):
        t0 = time.perf_counter()
        fr.render(download=False)
        raw, den = rmses()
        t += time.perf_counter() - t0
        if min(raw, den) <= QUALITY_TARGET:
            secs, frames = t, i + 1
            break
    launches = dict(counts)
    q = torch.stack(list(fr.accum), -1).reshape(h, w, 3).reshape(h // 4, 4, w // 4, 4, 3).mean(dim=(1, 3))
    comp = _rmse(q, ref_q)
    emit("fovea4k_quality", width=w, height=h, foveation=dataclasses.asdict(fov), fused=fr.fused,
         sampling="sobol", russian_roulette=True, reached=secs is not None, seconds=secs,
         frames=frames, fovea_spp=None if frames is None else frames * fov.fovea_spp,
         final_rmse_raw=raw, final_rmse_denoised=den,
         gate_variant="denoised" if den < raw else "raw", companion_fullframe_rmse_q=comp,
         ref_spp=int(fd["spp"]), companion_ref_effective_spp=int(qd["effective_spp"]),
         jax_record=JAX_RECORD["fovea4k"], target=QUALITY_TARGET, launches=launches, card=card)
    if secs is None:
        raise AssertionError(f"fovea4k_quality: disc RMSE raw {raw}, denoised {den} after 16 frames")
    return {"fovea4k_quality": launches}


def aov_checkpoint(cs, probe, dev, card):
    """On the card: `Renderer.aovs()` shapes and ranges; `denoised_image()`
    against ops/denoise on the CPU of the same inputs (rtol 1e-4, atol
    1e-5: exp and the CUDA scalar divisions round a few ulps apart); a
    checkpoint saved after 2 frames and loaded into a fresh renderer, whose
    next frame equals the continuing renderer's bit for bit."""
    import tempfile

    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
    from optixpathtracer_tpu_torch.ops.denoise import atrous_denoise

    w, h = 400, 300
    cam = scenes.city_camera(w, h)

    def make():
        return make_disney_pt_renderer(cs, probe, cam, width=w, height=h, spp=2, max_depth=4,
                                       sampling="sobol", **BENCH_FLAGS)

    r = make()
    r.render_n(2)
    aov = r.aovs()
    shapes = {k: list(v.shape) for k, v in aov.items()}
    n_len = np.linalg.norm(aov["normal"], axis=-1)
    hit = aov["depth"] > 0
    # AOVs are means over a pixel's samples: where they hit different faces
    # the mean normal is shorter than 1
    ranges = dict(
        normal_len=[float(n_len.min()), float(n_len.max())],
        normal_len_median_on_hits=float(np.median(n_len[hit])),
        albedo=[float(aov["albedo"].min()), float(aov["albedo"].max())],
        alpha=[float(aov["alpha"].min()), float(aov["alpha"].max())],
        depth=[float(aov["depth"].min()), float(aov["depth"].max())], hit_share=float(hit.mean()))
    ok_aov = (shapes == {"normal": [h, w, 3], "albedo": [h, w, 3], "alpha": [h, w, 3], "depth": [h, w]}
              and all(np.isfinite(v).all() for v in aov.values())
              and ranges["albedo"][0] >= 0 and ranges["albedo"][1] <= 1
              and ranges["alpha"][0] >= 0 and ranges["alpha"][1] <= 1 + 1e-6
              and ranges["depth"][0] >= 0 and 0 < ranges["hit_share"] < 1
              and ranges["normal_len"][1] <= 1 + 1e-3
              and abs(ranges["normal_len_median_on_hits"] - 1) < 1e-3)
    got = r.denoised_image()
    want = atrous_denoise(*(torch.as_tensor(np.ascontiguousarray(a)) for a in (
        r.accum_image(), aov["normal"], aov["albedo"]))).numpy()
    dn_err = float(np.abs(got - want).max())
    ok_dn = np.allclose(got, want, rtol=1e-4, atol=1e-5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.npz")
        r.save_checkpoint(path)
        r2 = make()
        r2.load_checkpoint(path)
    r.render(download=False)
    r2.render(download=False)
    ckpt_equal = bool(np.array_equal(r.accum_image(), r2.accum_image()))
    emit("aov_checkpoint", width=w, height=h, aov_shapes=shapes, aov_ranges=ranges,
         denoised_vs_cpu_max_abs=dn_err, denoise_tol=dict(rtol=1e-4, atol=1e-5),
         checkpoint_next_frame_bit_equal=ckpt_equal, subframe_after_load=r2.subframe_index, card=card)
    if not (ok_aov and ok_dn and ckpt_equal):
        raise AssertionError(f"aov_checkpoint: aovs {ok_aov}, denoise {ok_dn} ({dn_err}), "
                             f"checkpoint bit-equal {ckpt_equal}")


def quality_profile(cs, probe, dev, card):
    """The Sobol city frame (1200x800, 2 spp, depth 4, the bench's flags)
    and an adaptive refine round: the median of 3 unprofiled steps, then one
    profiled step: device busy, wall, idle share, peak memory, and the Sobol
    draws' device time and share of the busy time (the draws wrapped in a
    `record_function` for that step only). Beside it, one `_sobol_pair` on
    the step's lane count timed by CUDA events: the stream's elapsed time,
    the host's launch gaps included, times the draws counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.engine import wavefront
    from optixpathtracer_tpu_torch.engine.adaptive import AdaptiveRenderer
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer

    cam = scenes.city_camera(WIDTH, HEIGHT)
    real = wavefront._sobol_pair
    draws = []

    def annotated(pix, ctr, depth, salt):
        draws.append(pix.shape[0])
        with record_function("sobol_pair"):
            return real(pix, ctr, depth, salt)

    def profiled(name, step, lanes):
        step()  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        draws.clear()
        wavefront._sobol_pair = annotated
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            wavefront._sobol_pair = real
        events = prof.key_averages()
        busy = sum(_device_us(e) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.key != "sobol_pair") / 1e6
        sob = [e for e in events if e.key == "sobol_pair" and e.device_type == torch.autograd.DeviceType.CPU]
        sobol_prof_s = float(getattr(sob[0], "device_time_total", 0.0)) / 1e6 if sob else 0.0
        pix = torch.randint(0, WIDTH * HEIGHT, (lanes,), device=dev)
        ctr = torch.randint(0, 64, (lanes,), device=dev)
        pair_ms = cuda_ms(lambda: real(pix, ctr, 1, wavefront._LD_SALT_NEE), reps=5)
        if busy <= 0:
            raise AssertionError(f"{name}: the profiler recorded no device time")
        emit("quality_profile", frame=name, step_s=float(np.median(times)), step_times_s=times,
             wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
             max_memory_allocated=torch.cuda.max_memory_allocated(), sobol_draws=len(draws),
             lanes_per_draw=sorted(set(draws)), sobol_device_s=sobol_prof_s,
             sobol_share_of_busy=sobol_prof_s / busy, sobol_pair_stream_ms=pair_ms,
             sobol_stream_s=pair_ms / 1e3 * len(draws),
             top=[{"name": e.key[:60], "ms": _device_us(e) / 1e3, "calls": e.count}
                  for e in sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                                   and e.key != "sobol_pair"), key=_device_us, reverse=True)[:8]],
             card=card)

    r = make_disney_pt_renderer(cs, probe, cam, width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH,
                                sampling="sobol", **BENCH_FLAGS)
    profiled("sobol city frame", lambda: r.render(download=False), WIDTH * HEIGHT * SPP)
    del r
    ar = AdaptiveRenderer(cs, probe, RenderConfig(width=WIDTH, height=HEIGHT, samples_per_launch=SPP,
                                                  max_depth=DEPTH, traversal="cluster", sampling="sobol",
                                                  **BENCH_FLAGS), cam)
    ar.render()  # the warm-up round; the profiled round refines
    profiled("adaptive refine round", ar.render, ar.refine_tiles * 128 * ar.refine_spp)


def check_golden(phase, name, got, **fields):
    """Hold a render against its committed golden (sqrt-space RMSE)."""
    from optixpathtracer_tpu_torch import scenes

    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
    rmse = scenes.golden_rmse(got, want) if got.shape == want.shape else float("inf")
    emit(phase, name=name, rmse=rmse, tol=RMSE_TOL, **fields)
    if not rmse <= RMSE_TOL:
        raise AssertionError(f"golden {name}: RMSE {rmse} > {RMSE_TOL}")


def texture_card_eq(hs, dev, card):
    """`TexturePool.sample_bilinear` on the card against the CPU, bit for
    bit, on TEXTURE_LOOKUPS seeded fetches over the loft's pool (tex_id -1
    to 2, u and v uniform in [-3, 3] and a tenth of them integers); and the
    port's PNG decoder on this machine, which has no PIL, against the
    channel sums of PIL's decode (LOFT_PNG_SUMS)."""
    import torch

    from optixpathtracer_tpu_torch.core.scene import pack_textures
    from optixpathtracer_tpu_torch.io.image import read_rgb8

    rng = np.random.default_rng(3)
    n = TEXTURE_LOOKUPS
    tid = rng.choice(np.array([-1, 0, 1, 2], np.int32), n)
    uv = rng.uniform(-3, 3, (2, n)).astype(np.float32)
    ints = rng.random((2, n)) < 0.1
    uv[ints] = rng.integers(-3, 4, int(ints.sum()))
    args = (tid, uv[0], uv[1])
    outs = [pack_textures(hs.textures, d).sample_bilinear(*(torch.as_tensor(a, device=d) for a in args))
            for d in (dev, torch.device("cpu"))]
    got, want = [torch.stack(list(o)).cpu() for o in outs]
    mismatches = int((got != want).sum())
    sums = {name: read_rgb8(os.path.join(REPO, "scenes", name)).reshape(-1, 3).sum(0, dtype=np.int64).tolist()
            for name in LOFT_PNG_SUMS}
    emit("texture_card_eq", lookups=n, mismatches=mismatches,
         max_abs_diff=float((got - want).abs().max()), png_channel_sums=sums,
         png_equal_to_pil=sums == LOFT_PNG_SUMS, card=card)
    if mismatches or sums != LOFT_PNG_SUMS:
        raise AssertionError(f"texture_card_eq: {mismatches} texel values differ from the CPU's, "
                             f"PNG sums {sums} (PIL: {LOFT_PNG_SUMS})")


def loft_slice(dev, peak, card, counts):
    """bench.py's `--scene loft` row: scenes/loft.obj loaded and compiled,
    `disney_pt` at 1200x800, 2 spp, depth 4 with `scenes.loft_config`; then
    K1 (cluster boxes), K2 and K3 on its first and second bounce, its
    exactness gate and the texture checks. Returns (launches, kernel times
    at the first bounce)."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.io.obj import load_obj
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    t0 = time.perf_counter()
    hs = load_obj(scenes.LOFT_OBJ)
    load_s = time.perf_counter() - t0
    cs = compile_scene(hs, dev, leaf_size=8, cluster_size=256)
    torch.cuda.synchronize()
    cl = cs.clusters
    emit("loft_scene", triangles=cs.num_triangles, meshes=len(hs.meshes),
         textures=[list(t.shape) for t in hs.textures], entries=cl.num_entries,
         cluster_size=cl.cluster_size, walk=walk_of(cl), load_s=load_s, build_s=time.perf_counter() - t0)
    if walk_of(cl) != "flat":
        raise AssertionError(f"the loft has {cl.num_entries} entries: it would not take the flat walk")
    setup = scenes.loft_config(WIDTH, HEIGHT, dev)
    renderer = make_disney_pt_renderer(cs, setup.probe, setup.camera, width=WIDTH, height=HEIGHT,
                                       spp=SPP, max_depth=DEPTH, **setup.flags)
    launches = drive_slice("loft_slice", renderer, card, counts, flags=setup.flags, spp=SPP, walk="flat",
                           entries=cl.num_entries)
    check_walk("the loft slice", launches, "flat")
    profile_frame("loft_profile", renderer)

    cfg = renderer.config
    (o1, d1), (p_hit, wi, t_sh), _ = first_bounce_and_shadows(renderer, cl, setup.probe, dev)
    waves = {"first bounce": ((o1, d1, cfg.t_min, cfg.t_max), (p_hit, wi, cfg.shadow_t_min, t_sh)),
             "second bounce (the engine's)": engine_bounce(renderer, 1)}
    times = {}
    for label, ((o, d, t_min, t_max), (p, w, s_min, s_max)) in waves.items():
        times[label] = time_flat(cl, tc._pack_rays8(cl, o, d, t_min, t_max), tc.block_cull(cl, o, d, t_min, t_max),
                                 tc.block_cull(cl, p, w, s_min, s_max), peak, f"loft {label}, 1200x800x2spp", card)
    emit("loft_kernels", **{label: {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                                    for k, v in t.items()} for label, t in times.items()}, bit_equal=True, card=card)
    exactness_gate("loft_exactness_gate", cs, hs, setup.camera, dev)
    texture_card_eq(hs, dev, card)
    return launches, times


def cornell_slice(dev, card, counts):
    """The cornell golden's scene and quad light (tests/golden_scenes.py:39)
    at 1200x800, 2 spp, depth 4 with the bench's flags and emission on
    every bounce, through the `Renderer`: every bounce traces the probe
    NEE's and the quad NEE's shadow rays, so K3 runs twice a bounce.
    Returns the launches."""
    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.engine.renderer import Renderer
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig

    cs = compile_scene(scenes.cornell_scene(), dev, leaf_size=8, cluster_size=256)
    flags = dict(BENCH_FLAGS, emission_all_bounces=True)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_launch=SPP, max_depth=DEPTH,
                       traversal="cluster", **flags)
    renderer = Renderer(cs, scenes.dark_probe(dev), cfg, scenes.cornell_camera(WIDTH, HEIGHT),
                        area_light=scenes.cornell_light(dev))
    quad = frame_calls(renderer, ("_quad_nee",))["_quad_nee"]
    quad_rays = sum(int(out[2].sum()) for _, out in quad)
    launches = drive_slice("cornell_slice", renderer, card, counts, flags=flags, spp=SPP, walk=walk_of(cs.clusters),
                           entries=cs.clusters.num_entries, triangles=cs.num_triangles,
                           quad_nee_calls_per_frame=len(quad), quad_shadow_rays_per_frame=quad_rays)
    check_walk("the cornell slice", launches, "flat")
    any_per_frame = launches["any"] / (SLICE_FRAMES + 1)
    if any_per_frame != 2 * DEPTH or len(quad) != DEPTH:
        raise AssertionError(f"cornell: {any_per_frame} K3 launches and {len(quad)} quad NEE calls a frame, "
                             f"not {2 * DEPTH} and {DEPTH}")
    return launches


def file_goldens(dev):
    """The goldens of scenes from files and of the area light, on the card."""
    from optixpathtracer_tpu_torch import scenes

    renders = {**{n: lambda n=n: scenes.render_loft_golden(n, dev) for n in scenes.LOFT_GOLDENS},
               **{n: lambda n=n: scenes.render_cornell_golden(n, dev) for n in scenes.CORNELL_GOLDENS},
               "gltf": lambda: scenes.render_gltf_golden(dev)}
    for name in FILE_GOLDENS:
        check_golden("file_goldens", name, renders[name]())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        import optixpathtracer_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (optixpathtracer_tpu_torch not found)",
              file=sys.stderr)
        return 2

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.engine.foveated import FoveationConfig
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer, make_foveated_renderer
    from optixpathtracer_tpu_torch.ops import cuda_build
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip() if smi else 'unknown'}"
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build: one nvcc per source, all started together ------------------
    t0 = time.perf_counter()
    names = sorted({os.path.splitext(os.path.basename(src))[0] for src in SOURCES.values()})
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.load, names))
    builds = {}
    for name in names:
        info = cuda_build.build_info[name]
        builds[name] = dict(nvcc_seconds=info["seconds"], ptxas=[
            ln.strip() for ln in info["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln])
    emit("build", seconds=time.perf_counter() - t0, sources=builds)

    # ---- the city, and the slice's renderer ------------------------------
    t0 = time.perf_counter()
    hs = scenes.build_city_scene()
    cs = compile_scene(hs, dev, leaf_size=8, cluster_size=256)
    torch.cuda.synchronize()
    emit("scene", triangles=cs.num_triangles, entries=cs.clusters.num_entries,
         cluster_size=cs.clusters.cluster_size, build_s=time.perf_counter() - t0)
    cam = scenes.city_camera(WIDTH, HEIGHT)
    probe = scenes.city_sky(dev)
    renderer = make_disney_pt_renderer(cs, probe, cam, width=WIDTH, height=HEIGHT, spp=SPP,
                                       max_depth=DEPTH, **BENCH_FLAGS)
    cfg = renderer.config
    cl = cs.clusters
    launches = {}  # kernel -> launches over every main path
    c = cl.cluster_size
    sph_t, grp_t = cl.cull_tables

    # ---- kernels vs plain, bit for bit, on 64k mixed rays -----------------
    o, d = mixed_rays(cs, hs, cam, 65536, 7, dev)
    rays8 = tc._pack_rays8(cl, o, d, 1e-3, 1e16)
    errs = {"cull": compare("cull", tc.cull_blocks(rays8, sph_t, grp_t), tc._cull_torch(rays8, sph_t))}
    cr = tc.block_cull(cl, o, d, 1e-3, 1e16)
    errs["closest"] = compare("closest", tc.closest_sweep(cl.rows, cl.xf_inv, cr, c)[:2],
                              tc._closest_torch(cl.rows, cl.xf_inv, cr, c))
    cr_s = tc.block_cull(cl, o, d, 0.01, 1e16)
    errs["any"] = compare("any", (tc.any_sweep(cl.rows, cl.xf_inv, cr_s, c),),
                          (tc._any_torch(cl.rows, cl.xf_inv, cr_s, c),))
    emit("kernels_vs_plain", rays=65536, max_abs_err=errs, bit_equal=True)

    # ---- times at the slice's shapes: the first-bounce wavefront ----------
    # the flat walk (`flat_slice`: K1 on the cluster boxes, K2, K3) first,
    # then the city's own walk (`slice`: K1 on the entry boxes, K4a, K4b)
    (o1, d1), (p_hit, wi, t_sh), hit1 = first_bounce_and_shadows(renderer, cl, probe, dev)
    rays8_1 = tc._pack_rays8(cl, o1, d1, cfg.t_min, cfg.t_max)
    cr1 = tc.block_cull(cl, o1, d1, cfg.t_min, cfg.t_max)
    cr_sh = tc.block_cull(cl, p_hit, wi, cfg.shadow_t_min, t_sh)
    city_t, big_t = {}, {}  # kernel -> its times on one path's wavefronts
    peak = fp32_ops_per_s()
    wf = "first bounce, 1200x800x2spp"
    flat_t = time_flat(cl, rays8_1, cr1, cr_sh, peak, wf, card)
    # ---- K1 again on the engine's second bounce, and block_cull whole ------
    block_cull_parts("block_cull", tc.block_cull, cl, (o1, d1, cfg.t_min, cfg.t_max), (sph_t, grp_t), wf, card)
    (o2, d2, tm2, tM2), (p2, wi2, tms2, tMs2) = engine_bounce(renderer, 1)
    wf2 = "second bounce (the engine's), 1200x800x2spp"
    second_cull = cull_phase("cull", tc._pack_rays8(cl, o2, d2, tm2, tM2), sph_t, grp_t, peak,
                             PLAIN_BUDGET_S, wf2, card)
    block_cull_parts("block_cull", tc.block_cull, cl, (o2, d2, tm2, tM2), (sph_t, grp_t), wf2, card)
    block_cull_parts("block_cull", tc.block_cull, cl, (p2, wi2, tms2, tMs2), (sph_t, grp_t),
                     wf2 + ", shadow rays", card)
    # ---- the city's main path, the node walk: K1 on its entry boxes, K4a,
    # K4b, on the same first bounce and on the engine's second
    nt = cl.node_tables
    node_tables = (nt.node_sph_t, nt.node_box_t)
    city_t["cull"] = cull_phase("cull (node table)", rays8_1, *node_tables, peak, HIER_PLAIN_BUDGET_S, wf, card)
    block_cull_parts("block_cull_nodes", tc.block_cull_nodes, cl, (o1, d1, cfg.t_min, cfg.t_max),
                     node_tables, wf, card)
    city_t.update(time_hier(cl, tc.block_cull_nodes(cl, o1, d1, cfg.t_min, cfg.t_max),
                            tc.block_cull_nodes(cl, p_hit, wi, cfg.shadow_t_min, t_sh), peak, wf, card))
    second_node_cull = cull_phase("cull (node table)", tc._pack_rays8(cl, o2, d2, tm2, tM2), *node_tables,
                                  peak, HIER_PLAIN_BUDGET_S, wf2, card)
    second_hier = time_hier(cl, tc.block_cull_nodes(cl, o2, d2, tm2, tM2),
                            tc.block_cull_nodes(cl, p2, wi2, tms2, tMs2), peak, wf2, card)
    del o2, d2, tM2, p2, wi2, tMs2
    for name in ("closest", "any"):
        errs[name] = max(errs[name], flat_t[name]["max_abs_err"])
    for name in second_hier:
        errs[name] = max(city_t[name]["max_abs_err"], second_hier[name]["max_abs_err"])
    errs["cull"] = max(errs["cull"], flat_t["cull"]["max_abs_err"], second_cull["max_abs_err"],
                       city_t["cull"]["max_abs_err"], second_node_cull["max_abs_err"])

    # ---- the worklist builders (K5a, K5b) on the first bounce --------------
    wl_launches, timing = worklist_vs_plain(hit1, cr1.bits_lo, card)  # timing: the `kernels` line's
    launches.update(wl_launches)
    errs.update({k: v["max_abs_err"] for k, v in timing.items()})
    del cr1, cr_sh, rays8_1, hit1

    exactness_gate("exactness_gate", cs, hs, cam, dev)

    # ---- goldens on the card ---------------------------------------------
    for name in scenes.OPEN_GOLDENS:
        check_golden("golden", name, scenes.render_open_golden(name, dev))
    # ---- the sampling strategies: the card against the CPU -----------------
    sobol_card_eq(dev, card)
    sampling_card_vs_cpu(dev, card)

    # ---- the city slice: main path 1 (hier=None: the node walk from 74 entries)
    city_walk = walk_of(cl)
    city = drive_slice("slice", renderer, card, tc.launch_counts, spp=SPP, walk=city_walk,
                       entries=cl.num_entries, threshold=tc.HIER_MIN_ENTRIES)
    check_walk("the city slice", city, city_walk)
    profile_frame("profile", renderer)
    # ---- the same slice through the flat walk: the path of K2 and K3 ------
    with walk("flat"):
        flat_city = drive_slice("flat_slice", renderer, card, tc.launch_counts, spp=SPP, walk="flat")
    check_walk("the flat city slice", flat_city, "flat")
    emit("city_routes", entries=cl.num_entries, threshold=tc.HIER_MIN_ENTRIES,
         **route_turns(renderer, tc.launch_counts), card=card)
    del renderer, o, d, cr, cr_s
    torch.cuda.empty_cache()

    # ---- sv4 on the city: 3840x2160 in three launches (PERF.md §4's
    # configuration), the preset's default route there (fused=None: one
    # fused launch), 640x480 fused ----------------------------------------
    fov_runs, fov_frames = {}, {}
    for phase, size, kw in (
        ("fov_slice", FOV_4K, dict(fused=False)),
        ("fov_default_slice", FOV_4K, {}),
        ("fov_fused_slice", FOV_FUSED, dict(fused=True, foveation=FoveationConfig(
            inner_radius=max(8, 157 * 480 // 2160), outer_radius=max(24, 515 * 480 // 2160),
            fovea_spp=4))),
    ):
        fov = make_foveated_renderer(cs, probe, scenes.city_camera(size["width"], size["height"]),
                                     **size, **kw, **BENCH_FLAGS)
        fov_runs[phase] = drive_slice(
            phase, fov, card, tc.launch_counts, fused=fov.fused, foveation=dataclasses.asdict(fov.fov),
            zones=zone_lanes(fov))
        check_walk(phase, fov_runs[phase], city_walk)
        profile_frame(phase.replace("slice", "profile"), fov)
        fov_frames[phase] = (fov.accum_image(), fov.last_rays)  # after 5 frames each
        del fov
        torch.cuda.empty_cache()
    # the users' default 4K route against the three launches, frame for frame
    (img3, rays3), (img1, rays1) = fov_frames.pop("fov_slice"), fov_frames.pop("fov_default_slice")
    diff = float(np.abs(img1 - img3).max())
    emit("fov_fused_eq", **FOV_4K, max_abs_diff=diff, tol=1e-5, rays=[rays3, rays1])
    if not (np.allclose(img1, img3, rtol=1e-5, atol=1e-5) and rays1 == rays3):
        raise AssertionError(f"4K: the fused launch differs from three launches: {diff}, rays {rays3}, {rays1}")
    del fov_frames, img3, img1
    torch.cuda.empty_cache()

    # ---- the quality pipeline on the city (bench.py:508-913) ---------------
    quality_runs = quality_pipeline(cs, probe, dev, tc.launch_counts, card)
    quality_runs.update(fovea4k_quality(cs, probe, dev, tc.launch_counts, card))
    for path, run in quality_runs.items():
        check_walk(path, run, city_walk)
    aov_checkpoint(cs, probe, dev, card)
    quality_profile(cs, probe, dev, card)
    del cs, cl, hs
    foveated_checks(dev)  # the goldens, and fused == three launches
    torch.cuda.empty_cache()

    # ---- scenes from files and the area light: the flat walk's main paths
    loft_launches, loft_t = loft_slice(dev, peak, card, tc.launch_counts)
    for name in WALK_KERNELS["flat"]:
        errs[name] = max(errs[name], *(t[name]["max_abs_err"] for t in loft_t.values()))
    cornell_launches = cornell_slice(dev, card, tc.launch_counts)
    file_goldens(dev)
    torch.cuda.empty_cache()

    # ---- the gather probe (K6) -------------------------------------------
    g_launches, g_timing = gather_probe_phase(dev, card)
    launches.update(g_launches)
    timing["gather"] = g_timing
    errs["gather"] = g_timing["max_abs_err"]
    torch.cuda.empty_cache()

    # ---- the 8.7M-triangle scene (node walk) -------------------------------
    t0 = time.perf_counter()
    hs = scenes.build_big_scene(terrain_grid=scenes.BIG8X_TERRAIN_GRID)
    host_s = time.perf_counter() - t0
    cs = compile_scene(hs, dev, leaf_size=8, cluster_size=256)
    cl = cs.clusters
    nt = cl.node_tables
    torch.cuda.synchronize()
    emit("big_scene", triangles=cs.num_triangles, entries=cl.num_entries,
         nodes=nt.csph.shape[0], cluster_size=cl.cluster_size, scene_host_s=host_s,
         build_s=time.perf_counter() - t0, routes_to_node_walk=cl.num_entries >= tc.HIER_MIN_ENTRIES)
    if cl.num_entries < tc.HIER_MIN_ENTRIES:
        raise AssertionError(f"the big scene has {cl.num_entries} entries: it would not take the node walk")
    renderer = make_disney_pt_renderer(cs, probe, cam, width=WIDTH, height=HEIGHT, spp=SPP,
                                       max_depth=DEPTH, **BENCH_FLAGS)

    # ---- K4a/K4b vs plain, bit for bit, on mixed rays ----------------------
    o, d = mixed_rays(cs, hs, cam, 16384, 7, dev)
    cr = tc.block_cull_nodes(cl, o, d, 1e-3, 1e16)
    cr_s = tc.block_cull_nodes(cl, o, d, 0.01, 1e16)
    rays8 = tc._pack_rays8(cl, o, d, 1e-3, 1e16)
    node_err = compare("cull (node table)", tc.cull_blocks(rays8, nt.node_sph_t, nt.node_box_t),
                       tc._cull_torch(rays8, nt.node_sph_t))
    errs["cull"] = max(errs["cull"], node_err)
    nr_mixed = cr.ids.shape[0]
    checks = {}
    for name, kern, plain, crx in (
        ("closest_hier", lambda nr: tc.closest_hier_sweep(cl.rows, cl.xf_inv, nt, sub_cull(cr, nr), c)[:2],
         lambda nr: tc._closest_hier_torch(cl.rows, cl.xf_inv, nt, sub_cull(cr, nr), c), cr),
        ("any_hier", lambda nr: (tc.any_hier_sweep(cl.rows, cl.xf_inv, nt, sub_cull(cr_s, nr), c),),
         lambda nr: (tc._any_hier_torch(cl.rows, cl.xf_inv, nt, sub_cull(cr_s, nr), c),), cr_s),
    ):
        plain_ms, nr, err = check_vs_plain(name, kern, plain, nr_mixed, HIER_PLAIN_BUDGET_S)
        errs[name] = max(errs[name], err)
        checks[name] = dict(rays=nr * tc.BLOCK, plain_ms=plain_ms, max_abs_err=err,
                            max_nodes_per_block=int(crx.count.max()))
    emit("hier_kernels_vs_plain", node_cull_max_abs_err=node_err, bit_equal=True, **checks)
    del cr, cr_s, rays8

    # ---- times on the big slice's first and second bounce: node walk vs flat walk
    (o1, d1), (p_hit, wi, t_sh), _ = first_bounce_and_shadows(renderer, cl, probe, dev)
    rays8_1 = tc._pack_rays8(cl, o1, d1, cfg.t_min, cfg.t_max)
    cr1 = tc.block_cull_nodes(cl, o1, d1, cfg.t_min, cfg.t_max)
    cr_sh = tc.block_cull_nodes(cl, p_hit, wi, cfg.shadow_t_min, t_sh)
    nr_full = cr1.ids.shape[0]
    wf = "big scene first bounce, 1200x800x2spp"
    node_tables = (nt.node_sph_t, nt.node_box_t)
    big_t["cull"] = cull_phase("cull (node table)", rays8_1, *node_tables, peak, HIER_PLAIN_BUDGET_S, wf, card)
    block_cull_parts("block_cull_nodes", tc.block_cull_nodes, cl, (o1, d1, cfg.t_min, cfg.t_max),
                     node_tables, wf, card)

    first = time_hier(cl, cr1, cr_sh, peak, wf, card)
    big_t.update(first)
    # the second bounce is the engine's own: the rays `trace_wavefront` hands
    # to its sweeps at depth 1 of a frame of this renderer
    (o2, d2, tm2, tM2), (p2, wi2, tms2, tMs2) = engine_bounce(renderer, 1)
    wf2 = "big scene second bounce (the engine's), 1200x800x2spp"
    second_cull = cull_phase("cull (node table)", tc._pack_rays8(cl, o2, d2, tm2, tM2), *node_tables,
                             peak, HIER_PLAIN_BUDGET_S, wf2, card)
    errs["cull"] = max(errs["cull"], big_t["cull"]["max_abs_err"], second_cull["max_abs_err"])
    block_cull_parts("block_cull_nodes", tc.block_cull_nodes, cl, (o2, d2, tm2, tM2), node_tables, wf2, card)
    block_cull_parts("block_cull_nodes", tc.block_cull_nodes, cl, (p2, wi2, tms2, tMs2), node_tables,
                     wf2 + ", shadow rays", card)
    second = time_hier(cl, tc.block_cull_nodes(cl, o2, d2, tm2, tM2),
                       tc.block_cull_nodes(cl, p2, wi2, tms2, tMs2), peak, wf2, card)
    del o2, d2, tM2, p2, wi2, tMs2
    for name in first:
        errs[name] = max(errs[name], first[name]["max_abs_err"], second[name]["max_abs_err"])
    hier_ms = {"cull (node table)": big_t["cull"]["ms"], **{k: v["ms"] for k, v in first.items()}}
    # the flat walk on the same rays, kernels and entry points: the data a
    # measured routing threshold needs
    flat_tables = cl.cull_tables
    fcr1 = tc.block_cull(cl, o1, d1, cfg.t_min, cfg.t_max)
    fcr_sh = tc.block_cull(cl, p_hit, wi, cfg.shadow_t_min, t_sh)
    flat = dict(
        cull_ms=cuda_ms(lambda: tc.cull_blocks(rays8_1, *flat_tables), reps=3),
        closest_ms=cuda_ms(lambda: tc.closest_sweep(cl.rows, cl.xf_inv, fcr1, c), reps=3),
        any_ms=cuda_ms(lambda: tc.any_sweep(cl.rows, cl.xf_inv, fcr_sh, c), reps=3),
        max_entries_per_block=int(fcr1.count.max()),
    )
    del fcr1, fcr_sh
    entry = {}
    for route, hier in (("hier", True), ("flat", False)):
        entry[f"closest_hit_cluster_{route}_ms"] = cuda_ms(
            lambda: tc.closest_hit_cluster(cl, o1, d1, cfg.t_min, cfg.t_max, hier=hier), reps=3)
        entry[f"any_hit_cluster_{route}_ms"] = cuda_ms(
            lambda: tc.any_hit_cluster(cl, p_hit, wi, cfg.shadow_t_min, t_sh, hier=hier), reps=3)
    emit("flat_vs_hier_time", wavefront=wf, rays=nr_full * tc.BLOCK, flat_kernels=flat,
         hier_kernels=hier_ms, entry_points=entry,
         max_nodes_per_block=int(cr1.count.max()), threshold=tc.HIER_MIN_ENTRIES, card=card)
    del cr1, cr_sh, rays8_1, o1, d1, p_hit, wi, t_sh
    torch.cuda.empty_cache()

    # ---- exactness gate on the big scene (flat_scale_probe.py gate_n) ------
    og, dg = mixed_rays(cs, hs, cam, 4096, 42, dev)
    fast = tc.closest_hit_cluster(cl, og, dg, 1e-3, 1e16)  # hier=None: the node walk
    flat_rec = tc.closest_hit_cluster(cl, og, dg, 1e-3, 1e16, hier=False)
    t0 = time.perf_counter()
    exact = tc.reference_closest(cl, og, dg, 1e-3, 1e16)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    mismatch = int((fast.tri != exact.tri).sum())
    flat_mismatch = int((fast.tri != flat_rec.tri).sum())
    emit("hier_exactness_gate", rays=4096, mismatch=mismatch, flat_vs_hier_mismatch=flat_mismatch,
         hits=int((exact.tri >= 0).sum()), oracle_s=oracle_s)
    if mismatch or flat_mismatch:
        raise AssertionError(f"hier exactness gate: {mismatch} rays disagree with reference_closest, "
                             f"{flat_mismatch} with the flat walk")
    del og, dg, fast, flat_rec, exact

    # ---- a golden through the node walk -----------------------------------
    with walk("node"):
        before = dict(tc.launch_counts)
        got = scenes.render_open_golden("disney_open_s", dev)
        hier_launches = tc.launch_counts["closest_hier"] - before.get("closest_hier", 0)
    want = np.load(os.path.join(GOLDEN_DIR, "disney_open_s.npz"))["image"]
    rmse = scenes.golden_rmse(got, want)
    emit("hier_golden", name="disney_open_s", rmse=rmse, tol=RMSE_TOL, closest_hier_launches=hier_launches)
    if not (got.shape == want.shape and rmse <= RMSE_TOL and hier_launches > 0):
        raise AssertionError(f"hier golden disney_open_s: RMSE {rmse} (limit {RMSE_TOL}), "
                             f"{hier_launches} node-walk launches")

    # ---- the big slice: main path 2 ---------------------------------------
    big_launches = drive_slice("big_slice", renderer, card, tc.launch_counts, spp=SPP)
    check_walk("the big slice", big_launches, "node")
    profile_frame("big_profile", renderer)

    runs = {"slice": city, "flat_slice": flat_city, **fov_runs, **quality_runs, "loft": loft_launches,
            "cornell": cornell_launches, "big_slice": big_launches}
    for run in runs.values():
        for name, k in run.items():
            launches[name] = launches.get(name, 0) + k
    # each kernel's numbers on the path it serves first: K1, K4a and K4b on
    # the city's main path (the node walk), K2 and K3 on the flat city
    # slice; `paths` gives each path's launches and, where its first bounce
    # was timed, the kernel's ms there
    timed_at = {"slice": city_t, "flat_slice": flat_t, "loft": loft_t["first bounce"], "big_slice": big_t}
    timing.update(flat_t, **city_t)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": KERNELS[name],
         "launches": launches.get(name, 0), "max_abs_err": errs[name],
         **{k: timing[name][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            if k in timing[name]},
         "paths": {path: {"launches": run.get(name, 0),
                          **({k: timed_at[path][name][k] for k in ("ms", "plain_ms", "bound_ms")}
                             if name in timed_at.get(path, {}) else {})}
                   for path, run in runs.items() if run.get(name, 0)}}
        for name in KERNELS
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — report the failing phase, exit non-zero
        traceback.print_exc()
        emit("failed", error=traceback.format_exc().strip().splitlines()[-1])
        sys.exit(1)
