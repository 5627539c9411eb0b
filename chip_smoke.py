#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's eight hand-written CUDA kernels, one nvcc per source,
and the two native host libraries (csrc/host, one g++ each), all started
together (optixpathtracer_tpu_torch/csrc/: traverse_cluster.cu
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
     to its sweeps at depth 1 of a frame (`engine_bounce`);
  8. the engine's last options (`engine_options`): the city slice with
     `fused_shadows` off and on (equal images and rays; fused launches no
     K4b and one K4a a bounce over 2n rays), `env_via_bsdf` and `nee_rr`
     on the open scene against the port's CPU render;
  9. the instanced city (`scenes.instanced_city_glb(4)`: 9 glTF meshes, 144
     instances, 2.4M world triangles, 2416 entries) built as a TLAS and as
     its baked twin (`instanced_scene`); `disney_pt` at 1200x800, 4 spp,
     depth 4 through the CLI's own renderer (`cli.make_renderer`:
     `instanced_slice`, one launch profiled in `instanced_profile`), K1,
     K4a, K4b and, with the threshold raised, K1, K2, K3 held and timed on
     the engine's own first and second bounce (`instanced_kernels`), the
     flat walk's frame (`instanced_flat_slice`), the instanced-against-
     baked gate (`instanced_exactness_gate`), a transform update against a
     fresh build (`tlas_update`), and `python -m optixpathtracer_tpu_torch
     render` in two child processes (`cli_render`: the instanced city and
     the loft with --denoise; no jax, JAX package or PIL imported), started
     together with the other CLI children below and the scripts of 16 that
     measure nothing;
 10. the other presets (after the city's quality pipeline): `route_ties`
     (ROADMAP C.7: the flat and the node walk on the city's engine
     first-bounce rays and on hello's primary rays, t gated equal, the
     exact-t ties that resolve apart counted), `hello_slice` (bench.py's
     hello_raytracing row: the city at 1200x800, node walk, K1 / K4a / K4b
     then held against their plain versions on hello's own primary and
     unnormalised shadow rays), `spectral_slice` (bench.py's spectral row:
     the city at 1200x800, 2 spp, depth 4), `whitted_slice` (bench.py's
     whitted row: 768x576, depth 3, its own scene through the flat walk;
     K1 / K2 / K3 held on the deepest level's rays), `preset_goldens`
     (`hello`, `whitted*`, `spectral_s` within RMSE_TOL; `spectral` against
     the port's CPU render, ROADMAP C.8; a whitted frame with a curve, card
     against CPU) and, beside `cli_render`, `render --model
     hello_raytracing | whitted | spectral` at 96x64 in three child
     processes (`cli_preset`);
 11. demand-loaded textures and the viewer: bench.py's loft row shading
     from a one-level demand pool of 128 tiles (`demand_loft`: frames 0
     and 1 equal to the resident render within 1e-5, frame 1 loading no
     page; K1 / K2 / K3, settle launches counted), a 4096x4096 texture
     from a numpy seed on a receding plane at 1200x800 (`demand_big`:
     levels=1 equal to the resident render, levels=4 touching coarse pages
     with K1 / K2 / K3 held and timed on its rays and the card equal to
     the CPU on a 160x100 window at the frame's pixel footprint, and a
     pool below the working set ending after a bounded number of
     launches), the viewer in
     process (`view_slice`: `run_interactive` on a free port serving
     `cli.make_renderer`'s disney_pt on the city at 1200x800 and the
     foveated preset at 3840x2160 fused, driven over HTTP, with the
     publish (JPEG encode) time and the loop's frames a second), and
     `render --demand-textures 128` and `view --max-frames 2 --port 0` in
     two child processes (`cli_render`, `cli_view`);
 12. strip and lane sharding over `torch.distributed` (`dist_phases`, after
     `city_routes`): two gloo ranks sharing cuda:0 (NCCL cannot put two
     ranks on one card), spawned once, run the city slice through
     `DistributedRenderer` (`dist_city`: against one device at the
     reference's 2e-4 / 2e-5, rays per rank summing to `last_rays`, strip
     balance within 10 %, K1 / K4a / K4b launched on every rank, frame
     seconds and gather ms per rank), the sv4 4K preset through
     `DistributedFoveatedRenderer` over a gaze move (`dist_fov4k`: 1e-6,
     equal rays, lane balance within 10 %) and bench.py's loft row from a
     128-tile demand pool per rank (`dist_demand`: `pages_loaded` equal to
     one device's, the frame equal to the resident render within 1e-5);
     then the city slice with NCCL at world size 1 (`dist_nccl`), and
     `python -m optixpathtracer_tpu_torch.parallel.dryrun --ranks 2
     --device cuda:0` in a child process started before them and run
     beside them (`dryrun`); a rank that fails, hangs or exits non-zero
     fails the run;
 13. the loft with its textures re-encoded by the port's `encode_jpeg` and
     loaded through the new JPEG decoder (`jpeg_scene`, after the file
     goldens): texture fetch card == CPU bit for bit, a 160x100 render on
     the card against the port's CPU render, and one 2048x2048 JPEG
     decoded on the host, timed.
 14. the traversal backends without a kernel and the native host builders
     (`backend_phases`, after `engine_options`; `--only backends` runs the
     build, the city and these alone): `native_build` (the city's native
     builds against numpy), `lockstep_city` (bench.py's CPU headline on the
     card), `bfs_city`, `dense_loft`, `oracle_loft`, and later, beside the
     CLI's children, `lockstep_goldens`
     (the 14 goldens through the lockstep walk on the card against the
     port's CPU renders, which three worker processes started after the
     build compute beside the card's phases; both walks card against CPU
     within LOCKSTEP_GOLDEN_TOL, or the setups of ROADMAP C.9 within their
     pinned limits, `C9_PINNED`: `c9_card_vs_cpu`).
 15. the port's bench in child processes (after `dist_phases`; `--only
     bench` runs the build and these alone): `bench_small` (`python -m
     optixpathtracer_tpu_torch bench --small`: exit 0, the headline first
     and above 0, the gate's 8192 rays equal to the oracle's, no jax, JAX
     package or PIL imported) and `bench_hostile` (`python -m
     optixpathtracer_tpu_torch.bench --scene hostile` at 1200x800 x 2 spp
     with the gate and `measure_utilization`; then on the same scene and
     rays `closest_hit_cluster_exec_stats`: t equal to
     `closest_hit_cluster`'s, the executed pairs from the kernels' vis equal
     to `SweepWork.lane_pairs`, to the child's and, on 2048 rays, to the
     CPU's).
 16. the scripts beside the package as the port's modules (`scripts`;
     `--only scripts` runs the build and these alone), each as `python -m`
     runs it (no jax, JAX package or PIL imported; each run's launches
     counted from 0): after the bench, in a child process alone, the two
     whose frame rates are measured, `tools.fps_harness` at 1200x800 (10
     foveated frames, 1 uniform: both TSVs' columns and rows, foveated
     frames tracing fewer rays than uniform ones, both fps and their ratio)
     and `tools.interactive_session --frames 16`; the other six in two
     child processes (references, examples) started with `cli_render`'s,
     beside them:
     `tools.make_reference` at 600x400 with 8 and 64 spp (RMSE against
     scenes/ref_city_600x400.npz falling with spp, seconds per spp),
     `tools.make_reference_4k --disc-spp 16 --skip-q` (the disc's pixels
     equal to scenes/ref_city_4k_fovea.npz's, its RMSE there) and the four
     examples at their own sizes (a PNG of its size, not black, read
     without PIL; the demand demo's resident pages below the texture's).
 17. the texture formats beyond PNG and JPEG (`codecs_scene`, after
     `jpeg_scene`; `--only codecs` runs the build and this alone): every
     fixture of tests/torch_fixtures/textures decoded on this machine's
     host (no PIL) and held to its manifest (shape, channel sums, SHA-256
     of PIL's decode), each decode timed: the TIFF variants (CCITT,
     ThunderScan, LZMA, old LZW, the float predictor, 12-bit, CIELAB, JPEG
     CMYK, 16-bit planar tiles, orientations) and the raster formats (BLP,
     FTEX, DCX, ICNS, SUN, XBM, XPM, MSP, IM, SPIDER, FITS, IPTC, PIXAR,
     McIdas, GBR, XV thumbnails, IMT, CIELAB PSD) among them; the loft
     with its textures as TGA RLE, TIFF LZW and WebP lossless, and again
     as DCX, an LZMA TIFF stored transposed under orientation 5 and ICNS,
     and again in JPEG 2000 (a 5/3 JP2, a tiled RPCL codestream with
     precincts and three layers, an ICNS whose 256x256 entry is JPEG 2000,
     each tier-1 code-block through the native csrc/host/j2k_t1.cpp),
     through `load_obj`, each set's texture arrays equal to the PNG loft's
     and its card frame at JPEG_RENDER equal to the PNG loft's card frame
     bit for bit, its launches the PNG loft's; the loft with WebP lossy,
     DDS BC1 and arithmetic JPEG textures, again with AVIF textures at
     PIL's defaults (palette and IntraBC, each decoded by the native
     csrc/host/av1_dec.cpp), and again with AVIF textures written with
     PIL's options (`lossy3`: 4:4:4 with CDEF at speed 4, a premultiplied
     RGBA at speed 2 with loop restoration, 4:2:2), each card frame
     against the port's CPU frame within JPEG_RENDER_TOL, the AVIF lofts'
     launches the PNG loft's; K1 / K2 / K3 launched on the flat walk by
     every card render (`codecs_scene`, `codecs_scene_lossless2`,
     `codecs_scene_lossless3`, `codecs_scene_lossy2` and
     `codecs_scene_lossy3` in the kernels line's paths). The AVIF fixtures
     (the four quantizer buckets and lossless, speeds 0 / 5 / 6 / 10, 2 x 2
     tiles with 128 superblocks, odd sizes, both ranges, BT.601 / 709 /
     2020, an irot orientation; AVIF step 2's 4:4:4 / 4:2:2 / 4:0:0,
     straight and premultiplied alpha, loop restoration at speeds 0 / 2 /
     4, CDEF in three layouts, both filters on 128 superblocks, a
     two-frame sequence's still; AVIF step 3's 10- and 12-bit stills in
     every layout, with alpha, CDEF, loop restoration, palette and
     IntraBC, decoded by the uint16 build of av1_dec.cpp, their count and
     host ms reported with the 8-bit 1024 x 1024 one's; AVIF step 4's
     film grain, quantizer matrices, delta q and delta lf at 8, 10 and 12
     bits, each tool's count and host ms reported; AVIF step 5's AV1
     segmentation, grids (cropped, with alpha, at 10 bits) and the
     matrices libavif converts without libyuv, each variant's count and
     host ms reported; AVIF step 7's items holding AV1 inter frames
     (single references, translational motion, a fixed or per-block
     filter, at 8, 10 and 12 bits in every layout, with film grain, a
     hidden ALTREF frame, a frame after the shown one; _avif_step7), their
     count and host ms (total, largest, the 1024 x 1024 one's) reported)
     are held to the manifest, each decode timed, and the AVIF files of
     tests/torch_fixtures/avif_raises (a premultiplied alpha of another
     size, AVIF step 6; the inter tools of AVIF steps 8 and 9, each raising
     A.1 naming it; and what PIL refuses: C.14, the matrices of C.16, the
     first frames of C.17, a grid missing a cell) raise what its
     expected.json says, their count reported. The JPEG 2000 fixtures (every progression, POC, tiles and
     tile-parts, precincts, layers, each code-block style, SOP / EPH,
     ROI, PPT / PPM, precisions, subsampling, L / LA / RGBA / I;16 / CMYK /
     P / sYCC) are among the fixtures held to the manifest.

The cull (K1) is held against its plain version and timed on both tables
(cluster boxes and entry boxes on the city, entry boxes on the big scene)
at the first bounce and at the engine's second; `block_cull` lines time the whole of
`block_cull` / `block_cull_nodes` (pack, kernel, sort, gathers) beside the
kernel alone. hello's, whitted's and spectral's kernels are held and timed
on their own rays, with their bounds.

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
import re
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

try:  # shared with the port's bench: the gate, its rays, the walk, the card's FP32 rate, RMSE
    from optixpathtracer_tpu_torch.bench import (exactness_gate, fp32_ops_per_s, mixed_rays, sqrt_img,
                                                 sqrt_rmse, walk_of)
except ImportError:  # outside the repository, or no torch: main() says so and exits non-zero
    pass

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
RMSE_TOL = 2e-3  # tests/test_goldens.py
PLAIN_BUDGET_S = 60.0  # time a plain version at the slice shape within this
HIER_PLAIN_BUDGET_S = 30.0  # the same for the node walk's plain versions
# the same for every other wavefront (the engine's second bounces, the presets,
# demand_big, the big scene and its mixed rays): the bit-equality and plain_ms
# on the blocks that fit, plain_rays beside them
SIDE_PLAIN_BUDGET_S = 4.0
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
# the bench's build of the city (bench.py:1253-1255): no wide BVH, which
# only the BFS walk and the dense scan read
CITY_BUILD = dict(leaf_size=8, cluster_size=256, build_wide_bvh=False)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
_last_emit = [time.perf_counter()]


_CHILDREN = []  # the child processes started to run beside this one, stopped on exit


def _popen(cmd):
    """Start cmd in the repository as a child process whose output is read
    by `_wait`."""
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(proc)
    return proc


def _wait(proc, timeout_s):
    """(stdout, stderr) of a `_popen` child once it has exited; killed after
    timeout_s."""
    try:
        return proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise


def _stop_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


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


def cull_phase(name, rays8, sph_t, grp_t, peak, budget_s, wavefront, card, bound=True):
    """K1 on one table and one wavefront: its time on all blocks, bit-equality
    with `_cull_torch` on the blocks that fit the budget, and (bound=True)
    its bound from the slab tests this design must do (`cull_work`), with
    the count of all live-ray x box pairs and their bound beside it."""
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    out = time_vs_plain(
        name, lambda nr: tc.cull_blocks(rays8[: nr * tc.BLOCK], sph_t, grp_t),
        lambda nr: tc._cull_torch(rays8[: nr * tc.BLOCK], sph_t), rays8.shape[0] // tc.BLOCK,
        budget_s, wavefront=wavefront, card=card)
    if not bound:
        return out
    all_pairs = int((rays8[:, 7] > rays8[:, 6]).sum()) * sph_t.shape[1]
    out.update(work_bound(
        name, tc.cull_work(rays8, sph_t, grp_t), peak, out["ms"], wavefront=wavefront, card=card,
        groups=grp_t.shape[1], all_pairs_tests=all_pairs,
        all_pairs_bound_ms=all_pairs * tc.SLAB_OPS / peak * 1e3), library_ms=None)
    return out


def time_hier(cl, cr_c, cr_s, peak, wavefront, card, budget_s=HIER_PLAIN_BUDGET_S, bound=True):
    """K4a on cr_c and K4b on cr_s (NodeCullResults of cluster set cl):
    each kernel's time on the whole wavefront, bit-equality with its plain
    version on the blocks that fit budget_s, and (bound=True) K4a's vis
    against the counted visits and both bounds."""
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
                                  budget_s, wavefront=wavefront, card=card)
        if not bound:
            continue
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def check_vs_plain(name, kern, plain, nr_full, budget_s, probe_div=32):
    """Hold kern(nr) bit for bit against plain(nr) on the first nr ray blocks,
    nr cut so that the plain version runs within about budget_s (estimated
    from a run on 1/probe_div of the blocks, at least 8). kern/plain map a
    block count to a tuple of outputs. Returns (plain ms, nr, max_abs_err)."""
    probe_nr = min(nr_full, max(8, nr_full // probe_div))
    probe_ms, out_p = timed(lambda: plain(probe_nr))
    est_s = probe_ms / 1e3 * nr_full / probe_nr
    nr = nr_full if est_s <= budget_s else max(probe_nr, int(nr_full * budget_s / est_s))
    plain_ms = probe_ms
    if nr != probe_nr:
        plain_ms, out_p = timed(lambda: plain(nr))
    return plain_ms, nr, compare(name, kern(nr), out_p)


def time_vs_plain(name, kern, plain, nr_full, budget_s, probe_div=32, **fields):
    """Kernel ms on all nr_full blocks (mean of 5), then `check_vs_plain`."""
    from optixpathtracer_tpu_torch.ops.traverse_cluster import BLOCK

    ms = cuda_ms(lambda: kern(nr_full), reps=5)
    plain_ms, nr, err = check_vs_plain(name, kern, plain, nr_full, budget_s, probe_div)
    out = dict(ms=ms, plain_ms=plain_ms, rays=nr_full * BLOCK, plain_rays=nr * BLOCK,
               max_abs_err=err)
    emit("kernel_time", kernel=name, **out, **fields)
    return out


def time_flat(cl, rays8, cr, cr_s, peak, wavefront, card, budget_s=PLAIN_BUDGET_S, bound=True,
              probe_div=32):
    """The flat walk's kernels on one wavefront of cluster set cl: K1 on the
    cluster boxes (rays8), K2 on cr (the CullResult of those rays) and K3 on
    cr_s (that of their shadow rays). Each kernel's time on all blocks,
    bit-equality with its plain version on the blocks that fit budget_s,
    and (bound=True) its bound from the work these inputs need."""
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    c = cl.cluster_size
    out = {"cull": cull_phase("cull", rays8, *cl.cull_tables, peak, budget_s, wavefront, card, bound)}
    cases = {
        "closest": (cr, lambda nr: tc.closest_sweep(cl.rows, cl.xf_inv, sub_cull(cr, nr), c)[:2],
                    lambda nr: tc._closest_torch(cl.rows, cl.xf_inv, sub_cull(cr, nr), c)),
        "any": (cr_s, lambda nr: (tc.any_sweep(cl.rows, cl.xf_inv, sub_cull(cr_s, nr), c),),
                lambda nr: (tc._any_torch(cl.rows, cl.xf_inv, sub_cull(cr_s, nr), c),)),
    }
    for name, (crx, kern, plain) in cases.items():
        out[name] = time_vs_plain(name, kern, plain, crx.ids.shape[0], budget_s, probe_div,
                                  wavefront=wavefront, card=card)
        if not bound:
            continue
        work = tc.sweep_work(cl.rows, cl.xf_inv, crx, c, any_hit=name == "any")
        out[name].update(work_bound(name, work, peak, out[name]["ms"], wavefront=wavefront, card=card),
                         library_ms=None)
    return out


def gate_phase(phase, cs, hs, cam, dev, n=8192):
    """The bench's exactness gate (`bench.exactness_gate`: n mixed rays
    through both walks against `reference_closest`) as a phase; raises on
    any mismatch."""
    rec = exactness_gate(cs, hs, cam, dev, n)
    emit(phase, **rec)
    if rec["mismatch"] or rec["flat_vs_hier_mismatch"]:
        raise AssertionError(f"{phase}: {rec['mismatch']} rays disagree with reference_closest, "
                             f"{rec['flat_vs_hier_mismatch']} between the two walks")


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


SLICE_FRAME_S = {}  # phase -> median frame seconds of its `drive_slice`


def drive_slice(phase, renderer, card, counts, flags=BENCH_FLAGS, frames=SLICE_FRAMES, **fields):
    """The main path: one warm-up frame and `frames` timed frames, with the
    kernel launch counts set to 0 just before and read just after. Works
    for the `Renderer` and the `FoveatedRenderer` alike."""
    import torch

    cfg = renderer.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.clear()
    times = time_frames(renderer, frames)
    rays = int(renderer.last_rays if hasattr(renderer, "last_rays") else renderer.last_output.rays_traced)
    launches = dict(counts)
    img = renderer.accum_image()
    frame_s = float(np.median(times))
    SLICE_FRAME_S[phase] = frame_s
    emit(phase, width=cfg.width, height=cfg.height, max_depth=cfg.max_depth, flags=flags,
         **fields,
         frame_s=frame_s, frame_times_s=times, frame_s_range=[min(times), max(times)], rays_traced=rays,
         mrays_per_s=rays / frame_s / 1e6, max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, launches_per_frame={k: v / (frames + 1) for k, v in launches.items()},
         image_mean=float(img.mean()), card=card)
    if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError(f"{phase}: the frame is not a finite, non-black "
                             f"{cfg.width}x{cfg.height} image")
    return launches


WALK_KERNELS = {"node": ("cull", "closest_hier", "any_hier"), "flat": ("cull", "closest", "any")}


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


def profile_frame(phase, renderer, run=None, **fields):
    """One more frame under the profiler (not timed above): device busy time
    by kernel, and the device's idle share of the frame. `run` (default:
    one frame of `renderer`) is what is profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the device's activity alone: the host ops' events would repeat their
    # kernels' device time, and reading them back took seconds a frame
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run is None:
            renderer.render(download=False)
        else:
            run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6
    if busy <= 0:
        raise AssertionError(f"{phase}: the profiler recorded no device time: no idle share")
    top = sorted(events, key=_device_us, reverse=True)[:15]
    emit(phase, wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall, **fields,
         top=[{"name": e.key[:80], "ms": _device_us(e) / 1e3, "calls": e.count} for e in top])


def profile_launch(phase, renderer):
    """`profile_frame` of one launch of a `Renderer` frame: its first pixel
    chunk of `dispatch_tiles`, all samples and bounces. A frame of seven
    such launches is some 10^5 small device calls, whose trace alone takes
    the profiler a minute and a half to read back."""
    from optixpathtracer_tpu_torch.core.math import Vec3
    from optixpathtracer_tpu_torch.engine import renderer as rmod
    from optixpathtracer_tpu_torch.engine.wavefront import CameraParams

    cfg = renderer.config
    px, py = renderer.pixels
    chunk = -(-px.shape[0] // max(1, cfg.dispatch_tiles))
    acc = Vec3(*(c[:chunk] for c in renderer.accum))
    cam = CameraParams.from_camera(renderer.camera, renderer.device)
    profile_frame(phase, renderer, run=lambda: rmod._render_step(
        renderer.cs, renderer.probe, cfg, cam, px[:chunk], py[:chunk], acc, renderer.subframe_index,
        renderer.area_light), launch_pixels=chunk, launches_per_frame=cfg.dispatch_tiles)


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
    ref_sqrt = sqrt_img(torch.as_tensor(ref_d["image"].astype(np.float32), device=dev))  # canonical
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
            v = sqrt_rmse(torch.stack(list(r.accum), -1), ref_tile)
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
            sqrt_rmse(warm.denoised_tensor(), ref_img)
        del warm
        ar = make_adaptive()
        counts.clear()
        t = 0.0
        for _ in range(24):
            t0 = time.perf_counter()
            ar.render()
            v = sqrt_rmse(ar.denoised_tensor(), ref_img)
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
            v = sqrt_rmse(torch.stack(list(fr.accum), -1)[disc], ref_disc)
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
    ref_disc = sqrt_img(torch.as_tensor(fd["image"].astype(np.float32), device=dev))
    ref_q = sqrt_img(torch.as_tensor(qd["image"].astype(np.float32), device=dev))
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
    nrm, _, alb, _ = _hit_geometry(cs, rec, d3, False)
    hit = rec.t < 1e15
    g_nrm, g_alb = (torch.stack([torch.where(hit, c, 0.0) for c in v], -1).reshape(2 * half, 2 * half, 3)
                    for v in (nrm, alb))
    g_z = torch.where(hit, rec.t, 0.0).reshape(2 * half, 2 * half)

    def rmses():
        img = torch.stack(list(fr.accum), -1)  # (W*H, 3), canonical
        raw = sqrt_rmse(img[idx], ref_disc)
        crop = img.reshape(h, w, 3)[r0:r0 + 2 * half, c0:c0 + 2 * half]
        dn = atrous_denoise(crop, g_nrm, g_alb, sigma_color=4.0, sigma_albedo=1.0, depth=g_z,
                            demodulate=True)
        return raw, sqrt_rmse(dn[disc_rows, disc_cols], ref_disc)

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
    comp = sqrt_rmse(q, ref_q)
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


def texture_fetch_card_eq(hs, dev):
    """`TexturePool.sample_bilinear` over a host scene's textures on the card
    against the CPU, on TEXTURE_LOOKUPS seeded fetches (tex_id -1 to 2, u
    and v uniform in [-3, 3] and a tenth of them integers): (values that
    differ, their largest difference)."""
    import torch

    from optixpathtracer_tpu_torch.core.scene import pack_textures

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
    return int((got != want).sum()), float((got - want).abs().max())


def texture_card_eq(hs, dev, card):
    """The loft's texture fetches card == CPU bit for bit
    (`texture_fetch_card_eq`), and the port's PNG decoder on this machine,
    which has no PIL, against the channel sums of PIL's decode
    (LOFT_PNG_SUMS)."""
    from optixpathtracer_tpu_torch.io.image import read_rgb8

    mismatches, max_diff = texture_fetch_card_eq(hs, dev)
    sums = {name: read_rgb8(os.path.join(REPO, "scenes", name)).reshape(-1, 3).sum(0, dtype=np.int64).tolist()
            for name in LOFT_PNG_SUMS}
    emit("texture_card_eq", lookups=TEXTURE_LOOKUPS, mismatches=mismatches,
         max_abs_diff=max_diff, png_channel_sums=sums,
         png_equal_to_pil=sums == LOFT_PNG_SUMS, card=card)
    if mismatches or sums != LOFT_PNG_SUMS:
        raise AssertionError(f"texture_card_eq: {mismatches} texel values differ from the CPU's, "
                             f"PNG sums {sums} (PIL: {LOFT_PNG_SUMS})")


def loft_slice(dev, peak, card, counts):
    """bench.py's `--scene loft` row: scenes/loft.obj loaded and compiled,
    `disney_pt` at 1200x800, 2 spp, depth 4 with `scenes.loft_config`; then
    K1 (cluster boxes), K2 and K3 on its first and second bounce, its
    exactness gate and the texture checks. Returns (launches, kernel times
    at the first bounce, (compiled scene, host scene, setup))."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.io.obj import load_obj
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    t0 = time.perf_counter()
    hs = load_obj(scenes.LOFT_OBJ)
    load_s = time.perf_counter() - t0
    cs = compile_scene(hs, dev, **CITY_BUILD)
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
    gate_phase("loft_exactness_gate", cs, hs, setup.camera, dev)
    texture_card_eq(hs, dev, card)
    return launches, times, (cs, hs, setup)


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

    cs = compile_scene(scenes.cornell_scene(), dev, **CITY_BUILD)
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


# ---- demand-loaded textures and the viewer ---------------------------------

DEMAND_TOL = 1e-5  # tests/test_demand_engine.py:57-78: settled == resident
DEMAND_BIG = 4096  # the reference sources' default size (io/demand.py:83-84): 4489 base pages
DEMAND_SEED = 12
DEMAND_VIEW = dict(eye=(0, 1.5, 8), lookat=(0, 0.5, 0), up=(0, 1, 0), fov_y=50)  # the receding plane's camera
DEMAND_WINDOW = (160, 100)  # demand_big (b)'s card-against-CPU renders
# the window's card-against-CPU limit, sqrt-space RMSE: it reads 2.8e-5
# sound; planted faults read 1.9e-4 to 2.2e-2 (tests/demand_fault_readings.py)
DEMAND_WINDOW_TOL = 1e-4


def _demand_window():
    """The window camera of demand_big (b)'s card-against-CPU renders: a
    DEMAND_WINDOW view of the near plane inside the 1200x800 frame, with
    that frame's pixel angle, so that its hits take the mip levels the
    frame's own near plane takes (levels 1-3). A 160x100 render of the
    whole view samples every hit at the last level, where a wrong LOD
    changes no pixel. Its paths part between card and CPU more often than
    the whole view's, hence DEMAND_WINDOW_TOL."""
    half = np.tan(np.radians(DEMAND_VIEW["fov_y"] / 2)) * DEMAND_WINDOW[1] / HEIGHT
    return dict(lookat=(0.0, 0.0, 3.0), fov_y=float(np.degrees(2 * np.arctan(half))))


def _timed_requests(mgr):
    """Wrap mgr.process_requests to add its host seconds to a list."""
    spent = []
    real = mgr.process_requests

    def call(requests):
        t0 = time.perf_counter()
        out = real(requests)
        spent.append(time.perf_counter() - t0)
        return out

    mgr.process_requests = call
    return spent


def _pool_mb(mgr):
    return sum(t.numel() * t.element_size() for t in mgr.pool) / 1e6


def demand_loft(cs, hs, setup, dev, card, counts):
    """bench.py's loft row (1200x800, 2 spp, depth 4, `scenes.loft_config`)
    shading from a one-level demand pool of 128 tiles (3 textures x 25
    pages): frames 0 and 1 against the resident-TexturePool renderer within
    DEMAND_TOL, frame 1 loading no page. Launch counts cover the demand
    renderer's frames, settle launches included. Returns the launches."""
    import torch

    from optixpathtracer_tpu_torch.io.demand import DemandTextureManager
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer

    def renderer(demand=None):
        return make_disney_pt_renderer(cs, setup.probe, setup.camera, width=WIDTH, height=HEIGHT, spp=SPP,
                                       max_depth=DEPTH, demand=demand, **setup.flags)

    resident = renderer()
    want, resident_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        resident.render(download=False)
        resident_s.append(time.perf_counter() - t0)
        want.append(resident.accum_image())
    mgr = DemandTextureManager.from_host_scene(hs, capacity=128, levels=1, device=dev)
    host_s = _timed_requests(mgr)
    demand = renderer(mgr)
    torch.cuda.synchronize()
    counts.clear()
    frames = []
    for f in range(2):
        before = mgr.pages_loaded
        t0 = time.perf_counter()
        demand.render(download=False)
        frames.append(dict(frame=f, frame_s=time.perf_counter() - t0, resident_frame_s=resident_s[f],
                           pages_loaded=mgr.pages_loaded - before, launches=demand.last_launches,
                           max_abs_diff=float(np.abs(demand.accum_image() - want[f]).max())))
    launches = dict(counts)
    emit("demand_loft", width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH, pages=mgr.num_pages,
         capacity=mgr.capacity, pool_mb=_pool_mb(mgr), frames=frames,
         process_requests_ms=[t * 1e3 for t in host_s], launches=launches,
         launches_per_frame={k: v / 2 for k, v in launches.items()}, tol=DEMAND_TOL, card=card)
    check_walk("demand_loft", launches, "flat")
    if any(fr["max_abs_diff"] > DEMAND_TOL for fr in frames):
        raise AssertionError(f"demand_loft: settled frames differ from the resident render: {frames}")
    if frames[0]["pages_loaded"] <= 0 or frames[1]["pages_loaded"] != 0:
        raise AssertionError(f"demand_loft: pages loaded per frame {[f['pages_loaded'] for f in frames]}")
    return launches


def _plane_scene(tex):
    """tests/test_demand_engine.py:186-212's receding plane (240 units,
    the texture repeated 40 times) under `tex`, with the box of the
    engine test's textured scene on it."""
    from optixpathtracer_tpu_torch.core.materials import make_material
    from optixpathtracer_tpu_torch.core.scene import HostScene, Mesh

    hs = HostScene()
    tid = hs.add_texture(tex)
    s = 120.0
    hs.add_mesh(Mesh(
        vertices=np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 1, 0]] * 4, np.float32),
        texcoords=np.array([[0, 0], [40, 0], [40, 40], [0, 40]], np.float32),
        material=make_material(color=(1, 1, 1), texture_id=tid)))
    hs.add_box(make_material(color=(0.8, 0.4, 0.2), roughness=0.4), pos=(0, 0.4, 0), extent=(0.4, 0.4, 0.4))
    return hs


def demand_big(dev, peak, card, counts):
    """The state size the pager exists for: one DEMAND_BIGxDEMAND_BIG
    texture from numpy.random.default_rng(DEMAND_SEED) (201 MB) on the
    receding plane at 1200x800, 2 spp, depth 4 with the bench's flags,
    against the resident-TexturePool render: (a) levels=1, capacity 4608
    (every base page): the settled frame within DEMAND_TOL; (b) levels=4
    (the CLI render's setting), capacity 6144 (every page): level > 0
    pages touched, the frame settles, and its mean within 10 % of the
    resident render's; K1 / K2 / K3 held bit-equal to their plain versions
    and timed on this frame's first-bounce rays and shadow rays and on the
    engine's second bounce; and the card against the port's CPU render of
    the same pool at 160x100, of the whole view and of `_demand_window`:
    equal page tables (in the window a LOD a quarter level off moves
    pages), the whole view within SAMPLING_TOL, sqrt-space RMSE, as every
    card-against-CPU render here, the window within DEMAND_WINDOW_TOL;
    (c) capacity 1024, below the working set: the first frame ends after a
    bounded number of launches with subframe_index 1, and a second frame
    evicts. Returns (the launches of the demand renders on the card, the
    kernel times by wavefront)."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.camera import Camera
    from optixpathtracer_tpu_torch.engine.renderer import Renderer
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
    from optixpathtracer_tpu_torch.io.demand import DemandTextureManager
    from optixpathtracer_tpu_torch.lights.probe import build_probe
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    t0 = time.perf_counter()
    tex = np.random.default_rng(DEMAND_SEED).random((DEMAND_BIG, DEMAND_BIG, 3), dtype=np.float32)
    hs = _plane_scene(tex)
    texture_s = time.perf_counter() - t0

    def setup(device, w, h, **view):
        cs = compile_scene(hs, device, **CITY_BUILD)
        probe = build_probe(np.full((8, 16, 3), 1.0, np.float32), device)
        cfg = RenderConfig(width=w, height=h, samples_per_launch=SPP, max_depth=DEPTH, traversal="cluster",
                           **BENCH_FLAGS)
        cam = Camera(**{**DEMAND_VIEW, **view}, aspect_ratio=w / h)
        return cs, probe, lambda demand=None: Renderer(cs, probe, cfg, cam, demand=demand)

    cs, probe, make = setup(dev, WIDTH, HEIGHT)
    resident = make()
    t0 = time.perf_counter()
    resident.render(download=False)
    resident_s = time.perf_counter() - t0
    want = resident.accum_image()
    runs, launches, times = {}, {}, {}
    for name, levels, capacity in (("a", 1, 4608), ("b", 4, 6144), ("c", 1, 1024)):
        mgr = DemandTextureManager.from_host_scene(hs, capacity=capacity, levels=levels, device=dev)
        host_s = _timed_requests(mgr)
        r = make(mgr)
        torch.cuda.synchronize()
        counts.clear()
        t0 = time.perf_counter()
        r.render(download=False)
        frame_s = time.perf_counter() - t0
        usage = r.last_output.tex_usage.cpu().numpy()
        img = r.accum_image()
        first = dict(subframe_index=r.subframe_index, launches=r.last_launches, pages_loaded=mgr.pages_loaded)
        if name == "c":  # a second frame: the pool turns over
            r.render(download=False)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = dict(first_frame=first, frames=r.subframe_index,
            levels=levels, capacity=capacity, pages=mgr.num_pages, pool_mb=_pool_mb(mgr),
            pages_loaded=mgr.pages_loaded, pages_evicted=mgr.pages_evicted, launches=r.last_launches,
            pages_touched=int(usage.sum()), pending_after=int((usage & (mgr._page_table < 0)).sum()),
            levels_touched=sorted(set(mgr._page_lvl[np.nonzero(usage)[0]].tolist())),
            process_requests_ms=[t * 1e3 for t in host_s], frame_s=frame_s, resident_frame_s=resident_s,
            max_abs_diff=float(np.abs(img - want).max()),
            mean=float(img.mean()), resident_mean=float(want.mean()))
        if name == "b":  # the path's kernels on its own rays (launches not counted above)
            cfg, cl = r.config, cs.clusters
            (o1, d1), (p_hit, wi, t_sh), _ = first_bounce_and_shadows(r, cl, probe, dev)
            waves = {"first bounce": ((o1, d1, cfg.t_min, cfg.t_max), (p_hit, wi, cfg.shadow_t_min, t_sh)),
                     "second bounce (the engine's)": engine_bounce(r, 1)}
            for label, ((o, d, t_min, t_max), (p, w, s_min, s_max)) in waves.items():
                times[label] = time_flat(cl, tc._pack_rays8(cl, o, d, t_min, t_max),
                                         tc.block_cull(cl, o, d, t_min, t_max), tc.block_cull(cl, p, w, s_min, s_max),
                                         peak, f"demand_big {label}, 1200x800x2spp", card,
                                         budget_s=SIDE_PLAIN_BUDGET_S)
        del r, mgr
        torch.cuda.empty_cache()
    emit("demand_big_kernels", **{label: {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                                          for k, v in t.items()} for label, t in times.items()},
         bit_equal=True, card=card)
    # (b) on the card against the port's CPU render at 160x100: the whole
    # view, and a window at the 1200x800 frame's pixel footprint
    card_vs_cpu = {}
    for view, cam in (("view", {}), ("window", _demand_window())):
        imgs, tables = [], []
        for device in (dev, torch.device("cpu")):
            _, _, make_small = setup(device, *DEMAND_WINDOW, **cam)
            mgr = DemandTextureManager.from_host_scene(hs, capacity=6144, levels=4, device=device)
            r = make_small(mgr)
            r.render(download=False)
            imgs.append(r.accum_image())
            tables.append(mgr._page_table.copy())
        card_vs_cpu[view] = dict(camera=cam, sqrt_rmse=scenes.golden_rmse(*imgs),
                                 max_abs_diff=float(np.abs(imgs[0] - imgs[1]).max()),
                                 page_tables_equal=bool(np.array_equal(*tables)),
                                 levels_touched=sorted(set(mgr._page_lvl[tables[1] >= 0].tolist())))
    emit("demand_big", texture=[DEMAND_BIG, DEMAND_BIG], texture_mb=tex.nbytes / 1e6, texture_s=texture_s,
         width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH, runs=runs, card_vs_cpu=card_vs_cpu,
         launches=launches, tol=DEMAND_TOL, card_vs_cpu_tol=dict(view=SAMPLING_TOL, window=DEMAND_WINDOW_TOL),
         card=card)
    a, b, c = runs["a"], runs["b"], runs["c"]
    if a["max_abs_diff"] > DEMAND_TOL or a["pending_after"]:
        raise AssertionError(f"demand_big (a): settled frame {a['max_abs_diff']} from the resident render")
    if (max(b["levels_touched"]) <= 0 or b["pending_after"]
            or abs(b["mean"] - b["resident_mean"]) > 0.1 * b["resident_mean"]):
        raise AssertionError(f"demand_big (b): {b}")
    cv, cw = card_vs_cpu["view"], card_vs_cpu["window"]
    if (not (cv["page_tables_equal"] and cw["page_tables_equal"]) or cv["sqrt_rmse"] > SAMPLING_TOL
            or cw["sqrt_rmse"] > DEMAND_WINDOW_TOL or len(cw["levels_touched"]) < 2):
        raise AssertionError(f"demand_big (b): the card against the CPU: {card_vs_cpu}")
    if (c["first_frame"]["subframe_index"] != 1 or c["first_frame"]["launches"] > 32
            or c["pages_touched"] <= c["capacity"] or c["pages_evicted"] <= 0):
        raise AssertionError(f"demand_big (c): {c}")
    check_walk("demand_big", launches, "flat")
    return launches, times


VIEW_FRAMES = 7  # `run_interactive`'s max_frames per renderer in `view_slice`


def _jpeg_size(data: bytes) -> tuple[int, int]:
    """(height, width) of a baseline JPEG's SOF0 segment."""
    i = 2
    while data[i + 1] != 0xC0:
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return int.from_bytes(data[i + 5:i + 7], "big"), int.from_bytes(data[i + 7:i + 9], "big")


def _view_session(phase, renderer, camera, card, gaze=False):
    """`run_interactive` on `renderer` in a thread, VIEW_FRAMES frames,
    driven over HTTP: the page, /frame.jpg (SOI / EOI, SOF0 dimensions the
    frame's), /stats counting frames, a wheel event and a drag each moving
    the camera and restarting the accumulation on the next frame, and with
    gaze=True a move event setting the gaze to its pixel. The publish
    (encode) time is the median of the loop's own publishes (from numpy, as
    the loop sends them); then the last frame's encode from a tensor on the
    card."""
    import threading
    import urllib.request

    import torch

    from optixpathtracer_tpu_torch.io.image import encode_jpeg
    from optixpathtracer_tpu_torch.viewer import server as viewer_server

    started = []  # subframe index at the start of each frame: 0 after a camera change
    last = []  # the loop's last frame, as it was published
    real_render = renderer.render

    def render(*a, **kw):
        started.append(renderer.subframe_index)
        last[:] = [real_render(*a, **kw)]
        return last[0]

    renderer.render = render
    publish = []  # seconds of each of the loop's publishes
    real_publish = viewer_server.ViewerServer.publish

    def timed_publish(self, frame):
        t1 = time.perf_counter()
        real_publish(self, frame)
        publish.append(time.perf_counter() - t1)

    viewer_server.ViewerServer.publish = timed_publish
    with socket.socket() as s:  # a free port, known before the loop starts its server
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    failed = []

    def loop():
        try:
            viewer_server.run_interactive(renderer, camera, port=port, max_frames=VIEW_FRAMES)
        except Exception as e:  # noqa: BLE001 — re-raised below in the main thread
            failed.append(e)

    th = threading.Thread(target=loop)
    t0 = time.perf_counter()
    th.start()
    base = None

    def get(path):
        return urllib.request.urlopen(base + path, timeout=60).read()

    def frames_after(n):
        while len(started) < n and th.is_alive():
            th.join(0.005)
        if len(started) < n:
            raise AssertionError(f"{phase}: the loop ended after {len(started)} frames")

    def moved_and_restarted(event_paths):
        eye = camera.eye.copy()
        mark = len(started)
        for path in event_paths:
            get(path)
        moved = not np.allclose(camera.eye, eye)
        frames_after(mark + 2)
        return moved and 0 in started[mark:]

    try:
        frames_after(2)  # the first frame is published
        base = f"http://127.0.0.1:{port}"
        page = get("/")
        jpg = get("/frame.jpg")
        stats = json.loads(get("/stats"))
        checks = dict(page=b"optixpathtracer_tpu_torch" in page, jpeg_markers=jpg[:2] == b"\xff\xd8"
                      and jpg[-2:] == b"\xff\xd9", sof0=_jpeg_size(jpg) == (renderer.config.height,
                                                                        renderer.config.width),
                      stats_frames=stats.get("frames", 0) >= 1)
        w, h = renderer.config.width, renderer.config.height
        checks["wheel"] = moved_and_restarted(["/event?type=wheel&d=1"])
        checks["drag"] = moved_and_restarted([f"/event?type=down&x={w // 2}&y={h // 2}&b=0",
                                              f"/event?type=move&x={w // 2 + 40}&y={h // 2 + 25}&b=0"])
        if gaze:
            get(f"/event?type=move&x={w // 3}&y={h // 4}&b=-1")
            checks["gaze"] = tuple(renderer.gaze) == (w // 3, h // 4)
    finally:
        th.join()
        renderer.render = real_render
        viewer_server.ViewerServer.publish = real_publish
    loop_s = time.perf_counter() - t0
    if failed:
        raise failed[0]
    dev_frame = torch.as_tensor(np.ascontiguousarray(last[0]), device="cuda")
    encode_jpeg(dev_frame)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    data = encode_jpeg(dev_frame)
    device_ms = (time.perf_counter() - t1) * 1e3
    stats = renderer.stats()
    out = dict(width=w, height=h, frames=len(started), loop_s=loop_s, loop_fps=len(started) / loop_s,
               frame_s=stats.get("mean_frame_s", 1.0 / stats["fps"]), publish_ms=float(np.median(publish)) * 1e3,
               encode_from_card_tensor_ms=device_ms, jpeg_bytes=len(data), checks=checks)
    if not all(checks.values()) or _jpeg_size(data) != (h, w):
        raise AssertionError(f"{phase}: {out}")
    return out


def view_slice(cs, probe, dev, card, counts):
    """The viewer in process: `run_interactive` on a free port, serving
    `cli.make_renderer`'s disney_pt on the city at 1200x800 (the CLI's
    flags, 2 spp, depth 4) and the foveated preset at 3840x2160, fused.
    Returns the launches of both loops."""
    from optixpathtracer_tpu_torch import cli, scenes
    from optixpathtracer_tpu_torch.models import make_foveated_renderer
    from optixpathtracer_tpu_torch.utils.config import RunConfig

    counts.clear()
    cam = scenes.city_camera(WIDTH, HEIGHT)
    rc = RunConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH, traversal="cluster")
    city = _view_session("view_slice", cli.make_renderer(rc, cs, probe, cam), cam, card)
    cam4k = scenes.city_camera(**FOV_4K)
    fov = _view_session("view_slice", make_foveated_renderer(cs, probe, cam4k, **FOV_4K, fused=True,
                                                             **BENCH_FLAGS), cam4k, card, gaze=True)
    launches = dict(counts)
    emit("view_slice", disney_pt_city=city, foveated_4k_fused=fov, launches=launches, card=card)
    check_walk("view_slice", launches, walk_of(cs.clusters))
    return launches


def cli_demand_view(tmp, card):
    """`render --scene scenes/loft.obj --demand-textures 128` and `view
    --max-frames 2 --port 0` in two child processes started now, at 320x200
    (the render at 1 spp); the returned function waits for them: each exits
    0 and imports none of jax, the JAX package or PIL; the render prints the
    pool's page line (117 pages: the loft's three 256x256 textures over 4
    levels) and the viewer its address."""
    from optixpathtracer_tpu_torch import scenes

    small = ["--width", "320", "--height", "200"]  # the command's path, not its frame size
    runs = {"cli_render": ["render", "--scene", scenes.LOFT_OBJ, "--demand-textures", "128",
                           "--emission-all-bounces", *small, "--spp", "1", "--out", os.path.join(tmp, "ld.png")],
            "cli_view": ["view", "--max-frames", "2", "--port", "0", *small]}
    expect = {"cli_render": "demand textures: 117 pages, pool capacity 128",
              "cli_view": "viewer at http://127.0.0.1:"}
    t0 = time.perf_counter()
    procs = {name: _start(argv) for name, argv in runs.items()}

    def finish():
        for name, proc in procs.items():
            stdout, stderr = _wait(proc, CLI_TIMEOUT_S)
            imported = [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines() if ln.startswith("IMPORTED ")]
            emit(name, run="demand_textures" if name == "cli_render" else "view", argv=runs[name],
                 returncode=proc.returncode, wall_s=time.perf_counter() - t0, imported=imported,
                 stdout_tail=stdout[-400:], stderr_tail=stderr[-600:], card=card)
            if proc.returncode != 0 or expect[name] not in stdout:
                raise AssertionError(f"{name}: exit {proc.returncode}: {stdout[-800:]} {stderr[-2000:]}")
            if imported != [[]]:
                raise AssertionError(f"{name}: the child imported {imported}")

    return finish


INST_GRID = 4  # `scenes.instanced_city_glb` tiles per side: 144 instances, ~2.4M world triangles
INST_SPP = 4  # the CLI command's --spp
INST_PLAIN_BUDGET_S = 3.0  # plain-version budget per kernel and wavefront on the instanced city
GATE_T_TOL = 2e-4  # tests/test_tlas.py:99-101, instanced against baked
GATE_N_TOL = 1e-4  # world normals of `_hit_geometry`, instanced against baked
FUSED_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_fused_shadows.py:46
CLI_TIMEOUT_S = 300
METRIC_KEYS = {"i", "state_update_s", "render_s", "display_s", "cursor_x", "cursor_y", "t", "spp", "rays"}


def _allocated_by(fn):
    """(result of fn(), device bytes it left allocated)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def instanced_scene(tmp, dev):
    """`scenes.instanced_city_glb(INST_GRID)` written to tmp and built twice:
    `load_gltf_tlas` -> `compile_tlas(cluster_size=128)` (the CLI's
    `--instanced` build, with its per-prototype tables) and `load_gltf` ->
    `compile_scene` (the baked twin, the CLI's build without the flag)."""
    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene, compile_tlas
    from optixpathtracer_tpu_torch.io.gltf import load_gltf, load_gltf_tlas

    path = os.path.join(tmp, "city_tiles.glb")
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(scenes.instanced_city_glb(INST_GRID))
    glb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hs_t, groups, instances, _ = load_gltf_tlas(path)
    (cs_t, tables), tlas_bytes = _allocated_by(
        lambda: compile_tlas(hs_t, groups, instances, dev, cluster_size=128, return_tables=True))
    tlas_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hs_b, _ = load_gltf(path)
    cs_b, baked_bytes = _allocated_by(lambda: compile_scene(hs_b, dev, leaf_size=8, build_wide_bvh=False))
    baked_s = time.perf_counter() - t0
    cl = cs_t.clusters
    stored = sum(len(np.asarray(m.indices).reshape(-1, 3)) for m in hs_t.meshes)
    emit("instanced_scene", grid=INST_GRID, glb_bytes=os.path.getsize(path), glb_s=glb_s,
         prototypes=len(groups), instances=len(instances), world_triangles=cs_t.num_triangles,
         stored_triangles=stored, stored_slots=cl.rows.shape[0] * cl.rows.shape[2],
         stored_superclusters=cl.rows.shape[0], entries=cl.num_entries, cluster_size=cl.cluster_size,
         walk=walk_of(cl), tlas_build_s=tlas_s, tlas_device_bytes=tlas_bytes,
         baked_triangles=cs_b.num_triangles, baked_entries=cs_b.clusters.num_entries,
         baked_walk=walk_of(cs_b.clusters), baked_build_s=baked_s, baked_device_bytes=baked_bytes)
    if walk_of(cl) != "node" or cs_b.num_triangles != cs_t.num_triangles:
        raise AssertionError(f"instanced city: walk {walk_of(cl)}, {cs_t.num_triangles} world "
                             f"triangles against {cs_b.num_triangles} baked")
    return path, hs_t, groups, instances, cs_t, tables, hs_b, cs_b


def instanced_exactness_gate(cs_t, cs_b, hs_b, cam, dev, n=8192):
    """tests/test_tlas.py:82-101 at this scene's size: n mixed rays over the
    grid through the instanced city (its own walk, the node walk, and the
    flat walk) and through the baked twin; hit flags must agree on every
    ray, t within GATE_T_TOL and the world normals `_hit_geometry` resolves
    (shading normals on) within GATE_N_TOL. Returns the rays."""
    import torch

    from optixpathtracer_tpu_torch.engine import wavefront
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    og, dg = mixed_rays(cs_b, hs_b, cam, n, 42, dev)
    ri = tc.closest_hit_cluster(cs_t.clusters, og, dg, 1e-3, 1e16)
    rf = tc.closest_hit_cluster(cs_t.clusters, og, dg, 1e-3, 1e16, hier=False)
    rb = tc.closest_hit_cluster(cs_b.clusters, og, dg, 1e-3, 1e16)
    both = ri.hit & rb.hit
    flags = int((ri.hit != rb.hit).sum())
    t_bad = int((~torch.isclose(ri.t[both], rb.t[both], rtol=GATE_T_TOL, atol=GATE_T_TOL)).sum())
    ni = wavefront._hit_geometry(cs_t, ri, dg, True)[0]
    nb = wavefront._hit_geometry(cs_b, rb, dg, True)[0]
    n_err = torch.stack([(a - b).abs() for a, b in zip(ni, nb)]).amax(0)[both]
    n_bad = int((n_err > GATE_N_TOL).sum())
    walks = int((ri.t != rf.t).sum())  # the walks visit in different orders: exact-t ties
    ties = int(((ri.tri != rf.tri) & (ri.t == rf.t)).sum())  # may resolve to either triangle
    emit("instanced_exactness_gate", rays=n, hits=int(both.sum()), hit_flag_mismatch=flags,
         t_mismatch=t_bad, t_tol=GATE_T_TOL, max_t_rel_err=float(((ri.t[both] - rb.t[both]).abs()
                                                               / rb.t[both].abs().clamp(min=1.0)).max()),
         normal_mismatch=n_bad, normal_tol=GATE_N_TOL, max_normal_err=float(n_err.max()),
         flat_vs_node_t_mismatch=walks, flat_vs_node_exact_t_ties=ties)
    if flags or t_bad or n_bad or walks:
        raise AssertionError(f"instanced exactness gate: {flags} hit flags, {t_bad} t, {n_bad} normals "
                             f"differ from the baked twin; {walks} t between the walks")
    return og, dg


def tlas_update(cs_t, tables, hs_t, groups, instances, rays, dev):
    """`update_tlas_transforms` to a second set of tile transforms (each tile
    turned a further 90 degrees about y and moved by (7, 0, -5)) against a
    fresh `compile_tlas` with those transforms: the same tri and t, bit for
    bit, on `rays`, and the same `rows` tensor."""
    import torch

    from optixpathtracer_tpu_torch.builder import compile_tlas
    from optixpathtracer_tpu_torch.bvh.clusters import update_tlas_transforms
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    turn = np.array([[0.0, 0, 1, 7], [0, 1, 0, 0], [-1, 0, 0, -5], [0, 0, 0, 1]])
    moved_inst = [(p, turn @ m) for p, m in instances]
    t0 = time.perf_counter()
    moved = update_tlas_transforms(cs_t.clusters, tables, np.asarray([p for p, _ in moved_inst]),
                                   np.stack([m for _, m in moved_inst]))
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = compile_tlas(hs_t, groups, moved_inst, dev, cluster_size=128).clusters
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    og, dg = rays
    r1 = tc.closest_hit_cluster(moved, og, dg, 1e-3, 1e16)
    r2 = tc.closest_hit_cluster(fresh, og, dg, 1e-3, 1e16)
    same_rows = moved.rows.data_ptr() == cs_t.clusters.rows.data_ptr()
    tri_bad = int((r1.tri != r2.tri).sum())
    t_bad = int((r1.t != r2.t).sum())
    emit("tlas_update", rays=og.x.shape[0], hits=int(r1.hit.sum()), tri_mismatch=tri_bad,
         t_mismatch=t_bad, rows_same_tensor=same_rows, update_s=update_s, rebuild_s=rebuild_s)
    if tri_bad or t_bad or not same_rows or not int(r1.hit.sum()):
        raise AssertionError(f"tlas_update: {tri_bad} tri and {t_bad} t differ from a fresh build; "
                             f"rows kept: {same_rows}")


def instanced_phases(tmp, dev, peak, card, counts):
    """The instanced city through the CLI's own renderer (`cli.make_renderer`
    at the CLI command's flags), its kernels against their plain versions
    on both walks, the gates and the transform update. Returns (launches by
    path, first-bounce kernel times by path, max_abs_err by kernel)."""
    import torch

    from optixpathtracer_tpu_torch import cli, scenes
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
    from optixpathtracer_tpu_torch.utils.config import CameraSpec, RunConfig

    path, hs_t, groups, instances, cs_t, tables, hs_b, cs_b = instanced_scene(tmp, dev)
    cl = cs_t.clusters
    view = scenes.instanced_city_camera(WIDTH, HEIGHT, INST_GRID)
    # traversal: what `render --instanced` sets for a TLAS (cli.compile_run_scene)
    run = RunConfig(scene=path, instanced=True, width=WIDTH, height=HEIGHT, spp=INST_SPP,
                    max_depth=DEPTH, traversal="cluster", camera=CameraSpec(eye=view.eye, lookat=view.lookat,
                                                       up=view.up, fov_y=view.fov_y))
    cam = cli.make_camera(run)
    probe = cli._load_probe(run, dev)
    renderer = cli.make_renderer(run, cs_t, probe, cam)
    flags = dict(cli=True, dispatch_tiles=renderer.config.dispatch_tiles)
    inst = drive_slice("instanced_slice", renderer, card, counts, flags=flags, spp=INST_SPP,
                       walk=walk_of(cl), entries=cl.num_entries, instances=len(instances))
    check_walk("the instanced slice", inst, "node")
    profile_launch("instanced_profile", renderer)

    # the rays the engine hands to its sweeps at the first and the second
    # bounce of the first launch of a frame (one of dispatch_tiles pixel
    # chunks, sample 0); the sweeps' bounds at the first bounce only (the
    # counting walks over 2416 entries take tens of seconds)
    calls = frame_calls(renderer, ("closest_hit_cluster", "any_hit_cluster"))
    waves = {label: tuple(tuple(calls[name][depth][0][1:5]) for name in ("closest_hit_cluster", "any_hit_cluster"))
             for depth, label in enumerate(("instanced first bounce (the engine's)",
                                            "instanced second bounce (the engine's)"))}
    del calls
    nt = cl.node_tables
    node_t, flat_t = {}, {}
    for i, (label, ((o, d, t_min, t_max), (p, w, s_min, s_max))) in enumerate(waves.items()):
        node_t[label] = {"cull": cull_phase("cull (node table)", tc._pack_rays8(cl, o, d, t_min, t_max),
                                            nt.node_sph_t, nt.node_box_t, peak, INST_PLAIN_BUDGET_S,
                                            label, card)}
        node_t[label].update(time_hier(cl, tc.block_cull_nodes(cl, o, d, t_min, t_max),
                                       tc.block_cull_nodes(cl, p, w, s_min, s_max), peak, label, card,
                                       budget_s=INST_PLAIN_BUDGET_S, bound=i == 0))
        flat_t[label] = time_flat(cl, tc._pack_rays8(cl, o, d, t_min, t_max),
                                  tc.block_cull(cl, o, d, t_min, t_max), tc.block_cull(cl, p, w, s_min, s_max),
                                  peak, label + ", flat walk", card, budget_s=INST_PLAIN_BUDGET_S,
                                  bound=i == 0, probe_div=128)
        torch.cuda.empty_cache()
    del waves
    pick = ("ms", "plain_ms", "bound_ms", "max_abs_err", "rays", "plain_rays")
    emit("instanced_kernels", node_walk={lb: {k: {f: v.get(f) for f in pick} for k, v in t.items()}
                                         for lb, t in node_t.items()},
         flat_walk={lb: {k: {f: v.get(f) for f in pick} for k, v in t.items()} for lb, t in flat_t.items()},
         bit_equal=True, card=card)
    errs = {}
    for t in (*node_t.values(), *flat_t.values()):
        for k, v in t.items():
            errs[k] = max(errs.get(k, 0.0), v["max_abs_err"])
    with walk("flat"):
        inst_flat = drive_slice("instanced_flat_slice", renderer, card, counts, flags=flags, frames=1,
                                spp=INST_SPP, walk="flat", entries=cl.num_entries)
    check_walk("the instanced flat slice", inst_flat, "flat")
    del renderer
    torch.cuda.empty_cache()

    rays = instanced_exactness_gate(cs_t, cs_b, hs_b, cam, dev)
    del cs_b, hs_b
    torch.cuda.empty_cache()
    tlas_update(cs_t, tables, hs_t, groups, instances, rays, dev)
    first = next(iter(node_t))
    return ({"instanced": inst, "instanced_flat": inst_flat},
            {"instanced": node_t[first], "instanced_flat": flat_t[first]}, errs, path)


def engine_options(cs, probe, dev, card, counts):
    """The city slice (node walk, 1200x800 x 2 spp, depth 4, the bench's
    flags) with fused_shadows off and on: images within FUSED_TOL and equal
    `rays_traced`; fused launches no K4b and one K4a per bounce over 2n
    rays. Then env_via_bsdf and nee_rr = 0.5 on the open scene at 96x64,
    the card against the port's CPU render within SAMPLING_TOL. Returns the
    fused slice's launches."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.engine.renderer import Renderer
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer

    out = {}
    for fused in (False, True):
        r = make_disney_pt_renderer(cs, probe, scenes.city_camera(WIDTH, HEIGHT), width=WIDTH,
                                    height=HEIGHT, spp=SPP, max_depth=DEPTH, fused_shadows=fused,
                                    **BENCH_FLAGS)
        phase = "fused_shadows_slice" if fused else "unfused_shadows_slice"
        launches = drive_slice(phase, r, card, counts, flags=dict(BENCH_FLAGS, fused_shadows=fused),
                               spp=SPP, walk=walk_of(cs.clusters))
        sweeps = [args[1].x.shape[0] for args, _ in frame_calls(r, ("closest_hit_cluster",))["closest_hit_cluster"]]
        out[fused] = dict(launches=launches, img=r.accum_image(), rays=int(r.last_output.rays_traced),
                          frame_s=SLICE_FRAME_S[phase], sweep_rays=sweeps,
                          per_frame={k: v / (SLICE_FRAMES + 1) for k, v in launches.items()})
        del r
    off, on = out[False], out[True]
    diff = float(np.abs(on["img"] - off["img"]).max())
    lanes = WIDTH * HEIGHT * SPP
    emit("engine_options", fused_frame_s=on["frame_s"], unfused_frame_s=off["frame_s"],
         fused_launches_per_frame=on["per_frame"], unfused_launches_per_frame=off["per_frame"],
         fused_sweep_rays=on["sweep_rays"], unfused_sweep_rays=off["sweep_rays"],
         rays=[off["rays"], on["rays"]], max_abs_diff=diff, tol=FUSED_TOL, card=card)
    if not (np.allclose(on["img"], off["img"], **FUSED_TOL) and on["rays"] == off["rays"]):
        raise AssertionError(f"fused shadows differ from unfused: {diff}, rays {on['rays']} / {off['rays']}")
    if (on["launches"].get("any_hier", 0) or not on["launches"].get("cull", 0)
            or on["launches"].get("closest", 0) or on["per_frame"].get("closest_hier") != DEPTH + 1
            or on["sweep_rays"] != [2 * lanes] * (DEPTH + 1)):
        raise AssertionError(f"fused shadows: launches {on['per_frame']}, sweeps {on['sweep_rays']}")

    w, h = 96, 64
    rmse = {}
    for name, opts in (("env_via_bsdf", dict(env_via_bsdf=True)), ("nee_rr", dict(nee_rr=0.5)),
                       ("both_fused", dict(env_via_bsdf=True, nee_rr=0.5, fused_shadows=True))):
        imgs = []
        for d in (dev, torch.device("cpu")):
            cfg = RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=2,
                               traversal="cluster", **opts, **BENCH_FLAGS)
            r = Renderer(compile_scene(scenes.open_scene(), d), scenes.sky_probe(d), cfg,
                         scenes.open_camera(w, h))
            r.render_n(2)
            imgs.append(r.accum_image())
        rmse[name] = scenes.golden_rmse(*imgs)
        if not (np.isfinite(imgs[0]).all() and imgs[0].max() > 0):
            raise AssertionError(f"engine_options: {name} rendered no finite image")
    emit("engine_options_card_vs_cpu", width=w, height=h, spp=2, max_depth=2, frames=2,
         rmse_vs_cpu_port=rmse, tol=SAMPLING_TOL, card=card)
    if max(rmse.values()) > SAMPLING_TOL:
        raise AssertionError(f"engine_options: {rmse} above {SAMPLING_TOL}")
    return on["launches"]


_CHILD = """import json, runpy, sys
sys.argv = ["optixpathtracer_tpu_torch"] + json.loads(sys.argv[1])
rc = 0
try:
    runpy.run_module("optixpathtracer_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
print("IMPORTED " + json.dumps([m for m in ("jax", "optixpathtracer_tpu", "PIL") if m in sys.modules]))
sys.exit(rc)
"""


def _start(argv):
    """A child process running `_CHILD` on argv (the package's CLI arguments)."""
    return _popen([sys.executable, "-c", _CHILD, json.dumps(argv)])


def cli_render(glb, tmp, card):
    """`python -m optixpathtracer_tpu_torch render` as a user types it, in a
    child process each, both started now: the instanced city (the tentpole
    command, 2 frames, --metrics) and the loft with --denoise. The returned
    function waits for them: each must exit 0 and write a finite, not black
    PNG of its size that the port's decoder reads; the metrics file one row
    per frame with the reference's keys; and neither child may import jax,
    the JAX package or PIL."""
    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.io.image import read_rgb8

    metrics = os.path.join(tmp, "m.jsonl")
    runs = {
        "instanced_city": (["render", "--scene", glb, "--instanced", "--width", str(WIDTH), "--height",
                            str(HEIGHT), "--spp", str(INST_SPP), "--max-depth", str(DEPTH), "--frames", "2",
                            "--metrics", metrics, "--out", os.path.join(tmp, "i.png")], 2),
        "loft_denoise": (["render", "--scene", scenes.LOFT_OBJ, "--emission-all-bounces", "--spp", "2",
                          "--denoise", "--out", os.path.join(tmp, "l.png")], None),
    }
    t0 = time.perf_counter()
    procs = {name: _start(argv) for name, (argv, _) in runs.items()}

    def finish():
        for name, (argv, frames) in runs.items():
            stdout, stderr = _wait(procs[name], CLI_TIMEOUT_S)
            rc = procs[name].returncode
            imported = [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines() if ln.startswith("IMPORTED ")]
            out = argv[argv.index("--out") + 1]
            img = read_rgb8(out) if rc == 0 and os.path.exists(out) else None
            rows = []
            if frames:
                with open(metrics) as f:
                    rows = [json.loads(ln) for ln in f if ln.strip()]
            emit("cli_render", run=name, argv=argv, returncode=rc, wall_s=time.perf_counter() - t0,
                 shape=None if img is None else list(img.shape),
                 image_mean=None if img is None else float(img.mean()), metrics_rows=len(rows),
                 imported=imported, stdout_tail=stdout[-400:], stderr_tail=stderr[-800:], card=card)
            if rc != 0 or img is None:
                raise AssertionError(f"cli_render {name}: exit {rc}: {stderr[-2000:]}")
            if img.shape != (HEIGHT, WIDTH, 3) or not img.max() > 0:
                raise AssertionError(f"cli_render {name}: image {img.shape}, max {img.max()}")
            if imported != [[]]:
                raise AssertionError(f"cli_render {name}: the child imported {imported}")
            if frames and (len(rows) != frames or any(set(r) != METRIC_KEYS for r in rows)):
                raise AssertionError(f"cli_render {name}: metrics rows {rows}")

    return finish


# ---- the port's bench: its --small run and its hostile scene -------------

BENCH_TIMEOUT_S = 300
EXEC_CPU_RAYS = 2048  # rays of each utilisation set whose executed pairs are also counted on the CPU


def run_bench(phase, argv, card):
    """The port's bench in a child process started outside the repository
    (the package on PYTHONPATH): argv after `python`. Returns (stdout JSON
    rows, stderr detail, modules of jax / the JAX package / PIL imported,
    wall seconds); raises unless it exits 0 with its headline and detail."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=tmp, env=env, capture_output=True,
                              text=True, timeout=BENCH_TIMEOUT_S)
        wall = time.perf_counter() - t0
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    imported = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stdout.splitlines()
                if ln.startswith("IMPORTED ")]
    details = [json.loads(ln)["detail"] for ln in proc.stderr.splitlines() if ln.startswith('{"detail"')]
    if proc.returncode != 0 or not rows or not details:
        emit(phase, argv=argv, returncode=proc.returncode, stdout_tail=proc.stdout[-2000:],
             stderr_tail=proc.stderr[-4000:], card=card)
        raise AssertionError(f"{phase}: the bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    return rows, details[-1], imported, wall


def check_bench_headline(phase, rows, detail, label):
    """The headline first, under bench.py's metric string, above 0 and
    gated by the oracle with no ray apart; the timed frames through the
    kernels of the walk the scene takes."""
    head = rows[0]
    want = f"Mrays/s incoherent (Disney PT, depth 4, {label}, 1200x800)"
    if head.get("metric") != want or not head.get("value", 0) > 0:
        raise AssertionError(f"{phase}: headline {head}")
    if detail["gate_mismatch_rays"] != 0 or detail["quality_gated_out"]:
        raise AssertionError(f"{phase}: gate {detail['gate']}, overflow {detail['overflow']}")
    check_walk(phase, detail["launches"], detail["walk"])


def bench_small(card):
    """`python -m optixpathtracer_tpu_torch bench --small` as a user types
    it: exit 0, the headline first and above 0, the gate's 8192 rays equal
    to the oracle's, no jax, JAX package or PIL imported. Returns the timed
    frames' launches."""
    rows, detail, imported, wall = run_bench("bench_small", ["-c", _CHILD, json.dumps(["bench", "--small"])],
                                             card)
    emit("bench_small", wall_s=wall, rows=rows, detail=detail, imported=imported, card=card)
    check_bench_headline("bench_small", rows, detail, "150k-tri city")
    if imported != [[]]:
        raise AssertionError(f"bench_small: the child imported {imported}")
    return detail["launches"]


def exec_checks(cl, cl_cpu, cam, dev, util):
    """`closest_hit_cluster_exec_stats` on `measure_utilization`'s two ray
    sets: its t against `closest_hit_cluster`'s, its executed pairs (the
    kernels' vis) against `SweepWork.lane_pairs` of the same rays and
    against the bench child's number (util), and on the first
    EXEC_CPU_RAYS rays against the same function on the CPU (SweepWork's
    visits, no kernel)."""
    import torch

    from optixpathtracer_tpu_torch import bench
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    cpu = torch.device("cpu")
    c = cl.cluster_size
    ocam, dcam, ob, db = bench.utilization_rays(cl, cam)
    out = {}
    for name, o, d in (("camera", ocam, dcam), ("bounce_sorted", ob, db)):
        ov, dv = bench.v3(o, dev), bench.v3(d, dev)
        t_exec, pairs = tc.closest_hit_cluster_exec_stats(cl, ov, dv, 1e-3, 1e16)
        rec = tc.closest_hit_cluster(cl, ov, dv, 1e-3, 1e16)
        t_equal = torch.equal(torch.where(rec.tri < 0, tc.BIG_T, t_exec[: o.shape[0]]), rec.t)
        if walk_of(cl) == "node":
            work = tc.sweep_work_hier(cl.rows, cl.xf_inv, cl.node_tables,
                                      tc.block_cull_nodes(cl, ov, dv, 1e-3, 1e16), c)
        else:
            work = tc.sweep_work(cl.rows, cl.xf_inv, tc.block_cull(cl, ov, dv, 1e-3, 1e16), c)
        k = EXEC_CPU_RAYS
        t_k, pairs_k = tc.closest_hit_cluster_exec_stats(cl, bench.v3(o[:k], dev), bench.v3(d[:k], dev))
        t0 = time.perf_counter()
        t_cpu, pairs_cpu = tc.closest_hit_cluster_exec_stats(cl_cpu, bench.v3(o[:k], cpu),
                                                             bench.v3(d[:k], cpu))
        out[name] = dict(rays=o.shape[0], exec_pair_evals=pairs, lane_pairs=work.lane_pairs,
                         visits=work.visits, bench_exec_pair_evals=util[name]["exec_pair_evals"],
                         t_equal=t_equal, cpu_rays=k, exec_pair_evals_card=pairs_k,
                         exec_pair_evals_cpu=pairs_cpu, cpu_s=time.perf_counter() - t0,
                         t_card_equal_cpu=torch.equal(t_k.cpu(), t_cpu))
    return out


def bench_hostile(dev, card):
    """`python -m optixpathtracer_tpu_torch.bench --scene hostile` at full
    size (the 150k-triangle terrain and rotated city, 1200x800 x 2 spp, the
    gate and `measure_utilization`), then `exec_checks` on the same scene
    and rays in this process: t bit for bit, the card's executed pairs
    equal to SweepWork's count, to the child's and, on EXEC_CPU_RAYS rays,
    to the CPU's. Returns the timed frames' launches."""
    import torch

    from optixpathtracer_tpu_torch import bench, scenes
    from optixpathtracer_tpu_torch.builder import compile_scene

    rows, detail, _, wall = run_bench(
        "bench_hostile", ["-m", "optixpathtracer_tpu_torch.bench", "--scene", "hostile"], card)
    t0 = time.perf_counter()
    hs = scenes.build_hostile_scene()
    cl = compile_scene(hs, dev, **bench.BUILD).clusters
    cl_cpu = compile_scene(hs, torch.device("cpu"), **bench.BUILD).clusters
    checks = exec_checks(cl, cl_cpu, scenes.city_camera(WIDTH, HEIGHT), dev, detail["utilization"])
    emit("bench_hostile", wall_s=wall, checks_s=time.perf_counter() - t0, rows=rows, detail=detail,
         entries=cl.num_entries, walk=walk_of(cl), exec_checks=checks, card=card)
    check_bench_headline("bench_hostile", rows, detail, "150k-tri hostile terrain+rotated city")
    for name, ck in checks.items():
        if not (ck["t_equal"] and ck["t_card_equal_cpu"]
                and ck["exec_pair_evals"] == ck["lane_pairs"] == ck["bench_exec_pair_evals"]
                and ck["exec_pair_evals_card"] == ck["exec_pair_evals_cpu"] > 0):
            raise AssertionError(f"bench_hostile {name}: {ck}")
    return detail["launches"]


# ---- the other presets: hello_raytracing, whitted, spectral -------------

WHITTED_SIZE = dict(width=768, height=576, max_depth=3)  # bench.py:1151
SPECTRAL_SPP, SPECTRAL_FRAMES = 2, 2  # bench.py:1156-1160 (frames=2)
CLI_PRESETS = ("hello_raytracing", "whitted", "spectral")


@contextlib.contextmanager
def traced_rays(module, names, keep=False):
    """Wrap the trace functions `names` of `module` (each called as
    fn(scene, o, d, t_min, t_max, ...)) to count the live rays they are
    handed (t_max > t_min, summed on the device) and, with keep=True, to
    record each call's (name, o, d, t_min, t_max)."""
    import torch

    real = {n: getattr(module, n) for n in names}
    out = {"rays": None, "calls": []}

    def wrap(name):
        def call(scene, o, d, t_min, t_max, *args, **kw):
            n = o.x.shape[0]
            dev = o.x.device
            live = (torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
                    > torch.as_tensor(t_min, dtype=torch.float32, device=dev)).sum()
            out["rays"] = live if out["rays"] is None else out["rays"] + live
            if keep:
                out["calls"].append((name, o, d, t_min, t_max))
            return real[name](scene, o, d, t_min, t_max, *args, **kw)
        return call

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield out
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


def drive_preset(phase, renderer, card, counts, frames, module, names, **fields):
    """A preset's main path: one warm-up frame and `frames` timed frames,
    launch counts set to 0 just before and read just after, the live rays
    its trace calls were handed counted on the device, the frame checked
    finite, of its size and not black."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.clear()
    with traced_rays(module, names) as traced:
        times = time_frames(renderer, frames)
    launches = dict(counts)
    rays = int(traced["rays"]) / (frames + 1)
    img = renderer.frame if hasattr(renderer, "frame") else renderer.image_tensor()
    img = img.float().cpu().numpy()
    frame_s = float(np.median(times))
    SLICE_FRAME_S[phase] = frame_s
    per_pixel = {}
    if "rays_per_pixel" in fields:  # bench.py's count: that many rays a pixel, live or not
        per_pixel = dict(mrays_per_s_at_rays_per_pixel=fields["rays_per_pixel"] * fields["pixels"] / frame_s / 1e6)
    emit(phase, **fields, frame_s=frame_s, frame_times_s=times, frame_s_range=[min(times), max(times)],
         rays_traced_per_frame=rays, mrays_per_s=rays / frame_s / 1e6, **per_pixel,
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         launches_per_frame={k: v / (frames + 1) for k, v in launches.items()},
         image_mean=float(img.mean()), card=card)
    if not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError(f"{phase}: the frame is not finite and lit")
    return launches


def route_ties(cl, o1, d1, cfg, dev, card):
    """ROADMAP C.7 on the card: the flat and the node walk on the city's
    first-bounce rays (the engine's, sorted as it sorts them) and on
    hello's primary rays of the city. t must agree on every ray (else a walk
    is at fault); the exact-t ties that resolve to different triangles are
    counted, not gated (the port's pinned departure from the reference,
    whose rule routes the city to the flat walk)."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.engine.wavefront import CameraParams
    from optixpathtracer_tpu_torch.models import hello_raytracing as hr
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    ys, xs = np.divmod(np.arange(WIDTH * HEIGHT, dtype=np.int32), WIDTH)
    ho, hd = hr.camera_rays(hr.HelloConfig(width=WIDTH, height=HEIGHT),
                            CameraParams.from_camera(scenes.city_camera(WIDTH, HEIGHT), dev),
                            torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev))
    out = {}
    for label, (o, d, t_min, t_max) in (("city first bounce (the engine's, sorted)", (o1, d1, cfg.t_min, cfg.t_max)),
                                        ("hello primary rays", (ho, hd, 0.0, 1e20))):
        node = tc.closest_hit_cluster(cl, o, d, t_min, t_max, hier=True)
        flat = tc.closest_hit_cluster(cl, o, d, t_min, t_max, hier=False)
        out[label] = dict(rays=o.x.shape[0], hits=int(flat.hit.sum()),
                          t_mismatch=int((node.t != flat.t).sum()),
                          hit_mismatch=int((node.hit != flat.hit).sum()),
                          exact_t_ties_resolved_differently=int(((node.tri != flat.tri) & (node.t == flat.t)).sum()))
    emit("route_ties", entries=cl.num_entries, port_threshold=tc.HIER_MIN_ENTRIES, reference_threshold=3072,
         walks=out, not_counted="loft (1 entry) and cornell (fewer than 8 entries): both packages take "
         "the flat walk there", card=card)
    bad = {k: v for k, v in out.items() if v["t_mismatch"] or v["hit_mismatch"]}
    if bad:
        raise AssertionError(f"route_ties: the walks disagree in t or hits: {bad}")


def hello_slice(cs, dev, peak, card, counts):
    """bench.py's hello_raytracing row (`bench.py:1144`): the preset on the
    city at 1200x800, primary + one unnormalised shadow ray a pixel, the
    node walk (K1 on the entry boxes, K4a, K4b). Then K1, K4a and K4b held
    bit for bit against their plain versions on hello's own primary and
    shadow rays (a budgeted subset of the blocks)."""
    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.models import hello_raytracing as hr
    from optixpathtracer_tpu_torch.models import make_hello_renderer
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    cl = cs.clusters
    r = make_hello_renderer(cs, scenes.city_camera(WIDTH, HEIGHT), WIDTH, HEIGHT)
    launches = drive_preset("hello_slice", r, card, counts, SLICE_FRAMES, hr, ("trace_closest", "trace_occluded"),
                            width=WIDTH, height=HEIGHT, pixels=WIDTH * HEIGHT, rays_per_pixel=2,
                            walk=walk_of(cl))
    check_walk("the hello slice", launches, walk_of(cl))
    with traced_rays(hr, ("trace_closest", "trace_occluded"), keep=True) as traced:
        r.render(download=False)
    (_, o, d, t_min, t_max), (_, p, l, s_min, s_max) = traced["calls"]
    nt = cl.node_tables
    wf = "hello primary rays"
    out = {"cull": cull_phase("cull (node table)", tc._pack_rays8(cl, o, d, t_min, t_max), nt.node_sph_t,
                              nt.node_box_t, peak, SIDE_PLAIN_BUDGET_S, wf, card)}
    shadow = cull_phase("cull (node table)", tc._pack_rays8(cl, p, l, s_min, s_max), nt.node_sph_t, nt.node_box_t,
                        peak, SIDE_PLAIN_BUDGET_S, "hello shadow rays (unnormalised, t in (0, 1))", card)
    out.update(time_hier(cl, tc.block_cull_nodes(cl, o, d, t_min, t_max), tc.block_cull_nodes(cl, p, l, s_min, s_max),
                         peak, "hello primary / shadow rays", card, budget_s=SIDE_PLAIN_BUDGET_S))
    dlen = float((l.x * l.x + l.y * l.y + l.z * l.z).sqrt().median())
    emit("hello_kernels", median_shadow_dir_length=dlen, bit_equal=True,
         kernels={k: {f: v[f] for f in ("ms", "plain_ms", "rays", "plain_rays", "max_abs_err", "bound_ms",
                                       "bound_by")}
                  for k, v in out.items()}, shadow_cull=shadow, card=card)
    errs = {k: v["max_abs_err"] for k, v in out.items()}
    errs["cull"] = max(errs["cull"], shadow["max_abs_err"])
    return launches, out, errs


def whitted_slice(dev, peak, card, counts):
    """bench.py's whitted row (`bench.py:1151`): `make_whitted_renderer(768,
    576, 3)` on the card: spheres (dense), the floor box through the flat
    walk (one entry: K1, K2, and K3 for each point light's shadow rays at
    every level), the ray tree's 2^level x N rays a level. Then K1, K2, K3
    held against their plain versions on the deepest level's reflected and
    refracted rays and its first light's shadow rays."""
    import torch

    from optixpathtracer_tpu_torch.engine import whitted as tw
    from optixpathtracer_tpu_torch.models import make_whitted_renderer
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    r = make_whitted_renderer(**WHITTED_SIZE, device=dev)
    cl = r.cs.clusters
    launches = drive_preset("whitted_slice", r, card, counts, SLICE_FRAMES, tw, ("trace_closest", "trace_occluded"),
                            **WHITTED_SIZE, chunks=r.dispatch_tiles, entries=cl.num_entries, walk=walk_of(cl),
                            deepest_level_rays=WHITTED_SIZE["width"] * WHITTED_SIZE["height"]
                            * 2 ** WHITTED_SIZE["max_depth"] // r.dispatch_tiles)
    check_walk("the whitted slice", launches, walk_of(cl))
    with traced_rays(tw, ("trace_closest", "trace_occluded"), keep=True) as traced:
        r.render(download=False)
    closest = [c for c in traced["calls"] if c[0] == "trace_closest"]
    shadows = [c for c in traced["calls"] if c[0] == "trace_occluded"]
    _, o, d, t_min, t_max = closest[WHITTED_SIZE["max_depth"]]  # the first chunk's deepest level
    _, p, l, s_min, s_max = shadows[2 * WHITTED_SIZE["max_depth"]]  # its first point light
    del traced, closest, shadows
    out = time_flat(cl, tc._pack_rays8(cl, o, d, t_min, t_max), tc.block_cull(cl, o, d, t_min, t_max),
                    tc.block_cull(cl, p, l, s_min, s_max), peak,
                    f"whitted deepest level ({o.x.shape[0]} reflected + refracted rays)", card,
                    budget_s=SIDE_PLAIN_BUDGET_S)
    errs = {k: v["max_abs_err"] for k, v in out.items()}
    del r, o, d, p, l
    torch.cuda.empty_cache()
    return launches, out, errs


def spectral_slice(cs, probe, peak, card, counts):
    """bench.py's spectral row (`bench.py:1156-1160`): the hero-wavelength
    preset on the city at 1200x800, 2 spp, depth 4 (no coherence sort, as
    in the reference): closest and any hit through the node walk, 2 frames
    timed after a warm-up. Then K1, K4a and K4b held against their plain
    versions, timed and bounded on the frame's first closest-hit sweep and
    its first shadow sweep (a budgeted subset of the blocks). Returns
    (launches, kernel numbers, max errors)."""
    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.engine import wavefront as ts  # the spectral engine's sweeps go through it
    from optixpathtracer_tpu_torch.models import make_spectral_renderer
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    r = make_spectral_renderer(cs, probe, scenes.city_camera(WIDTH, HEIGHT), WIDTH, HEIGHT,
                               SPECTRAL_SPP, DEPTH)
    names = ("closest_hit_cluster", "any_hit_cluster")
    launches = drive_preset("spectral_slice", r, card, counts, SPECTRAL_FRAMES, ts, names, width=WIDTH,
                            height=HEIGHT, spp=SPECTRAL_SPP, max_depth=DEPTH, walk=walk_of(cs.clusters))
    check_walk("the spectral slice", launches, walk_of(cs.clusters))
    with traced_rays(ts, names, keep=True) as traced:
        r.render(download=False)
    (_, o, d, t_min, t_max), = [c for c in traced["calls"] if c[0] == names[0]][:1]
    (_, p, l, s_min, s_max), = [c for c in traced["calls"] if c[0] == names[1]][:1]
    del traced
    cl = cs.clusters
    nt = cl.node_tables
    out = {"cull": cull_phase("cull (node table)", tc._pack_rays8(cl, o, d, t_min, t_max), nt.node_sph_t,
                              nt.node_box_t, peak, SIDE_PLAIN_BUDGET_S, "spectral first bounce", card)}
    out.update(time_hier(cl, tc.block_cull_nodes(cl, o, d, t_min, t_max), tc.block_cull_nodes(cl, p, l, s_min, s_max),
                         peak, "spectral first bounce / its shadow rays", card, budget_s=SIDE_PLAIN_BUDGET_S))
    return launches, out, {k: v["max_abs_err"] for k, v in out.items()}


def preset_goldens(dev, card):
    """The `hello`, `whitted_s`, `whitted`, `spectral_s` goldens rendered on
    the card within RMSE_TOL; `spectral` (ROADMAP C.8: the golden's fused
    programs flip a few paths, the port misses it by a hair on the CPU as
    the eager reference does) held against the port's CPU render within
    RMSE_TOL, its golden RMSE reported; and one whitted frame with a curve
    (tests/test_curve_intersect.py's arch) on the card against the CPU."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.camera import Camera
    from optixpathtracer_tpu_torch.core.materials import make_material
    from optixpathtracer_tpu_torch.core.scene import HostScene
    from optixpathtracer_tpu_torch.engine.whitted import WhittedConfig
    from optixpathtracer_tpu_torch.lights import lights
    from optixpathtracer_tpu_torch.models.whitted import WhittedRenderer
    from optixpathtracer_tpu_torch.ops.curve_intersect import build_curves
    from optixpathtracer_tpu_torch.ops.dispatch import default_backend

    cpu = torch.device("cpu")
    for name in scenes.PRESET_GOLDENS:
        got = scenes.render_preset_golden(name, dev)
        if name != "spectral":
            check_golden("preset_golden", name, got, card=card)
            continue
        want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
        cpu_img = scenes.render_preset_golden(name, cpu)
        rmse_cpu = scenes.golden_rmse(got, cpu_img)
        emit("preset_golden", name=name, rmse_vs_cpu=rmse_cpu, tol=RMSE_TOL,
             rmse_vs_golden=scenes.golden_rmse(got, want), cpu_rmse_vs_golden=scenes.golden_rmse(cpu_img, want),
             pixels_apart_from_cpu=int((np.abs(got - cpu_img).max(-1) > 1e-3).sum()), card=card)
        if not rmse_cpu <= RMSE_TOL:
            raise AssertionError(f"spectral golden setup: the card is {rmse_cpu} from the CPU render")

    def curve_frame(device):
        hs = HostScene()
        hs.add_box(make_material(color=(0.75, 0.75, 0.75), roughness=0.9), pos=(0, -0.15, 0), extent=(8, 0.15, 8))
        arch = [[[-2.5, 0.0, 0.0, 0.45], [-1.0, 2.8, 0.0, 0.40], [1.0, 2.8, 0.0, 0.35], [2.5, 0.0, 0.0, 0.30]]]
        lt = lights.build_lights([lights.make_point_light((0.0, 9.0, 1.0), (1.0, 1.0, 1.0), intensity=140.0),
                                  lights.make_ambient_light((1.0, 1.0, 1.0), 0.10)], device)
        cfg = WhittedConfig(width=96, height=72, max_depth=1, antialias=False)
        cam = Camera(eye=(0.0, 2.2, 8.0), lookat=(0.0, 1.0, 0.0), up=(0, 1, 0), fov_y=40, aspect_ratio=96 / 72)
        r = WhittedRenderer(None, compile_scene(hs, device), lt, cfg, cam,
                            curves=build_curves(arch, [make_material(color=(0.9, 0.25, 0.2), roughness=0.5)], device))
        return r.render()

    with default_backend("cluster"):  # the same walk on the card and the CPU
        got, want = curve_frame(dev), curve_frame(cpu)
    rmse = scenes.golden_rmse(got, want)
    red = float(((got[..., 0] > 1.5 * got[..., 1]) & (got[..., 0] > 0.05)).mean())
    emit("curve_frame", width=96, height=72, rmse_vs_cpu=rmse, tol=RMSE_TOL,
         max_abs_diff=float(np.abs(got - want).max()), red_share=red, card=card)
    if not (rmse <= RMSE_TOL and red > 0.02):
        raise AssertionError(f"curve frame: RMSE {rmse} against the CPU, red share {red}")


def cli_presets(tmp, card):
    """`python -m optixpathtracer_tpu_torch render --model hello_raytracing |
    whitted | spectral` at 96x64, as a user types them, in three child
    processes started now; the returned function waits for them: each must
    exit 0, write a lit PNG of its size, and import none of jax, the JAX
    package or PIL."""
    from optixpathtracer_tpu_torch.io.image import read_rgb8

    procs = {}
    t0 = time.perf_counter()
    for model in CLI_PRESETS:
        out = os.path.join(tmp, f"{model}.png")
        argv = ["render", "--model", model, "--width", "96", "--height", "64", "--spp", "1",
                "--max-depth", "2", "--out", out]
        procs[model] = (argv, out, _start(argv))

    def finish():
        for model, (argv, out, proc) in procs.items():
            stdout, stderr = _wait(proc, CLI_TIMEOUT_S)
            imported = [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines() if ln.startswith("IMPORTED ")]
            img = read_rgb8(out) if proc.returncode == 0 and os.path.exists(out) else None
            emit("cli_preset", model=model, argv=argv, returncode=proc.returncode,
                 wall_s=time.perf_counter() - t0, shape=None if img is None else list(img.shape),
                 image_mean=None if img is None else float(img.mean()), imported=imported,
                 stdout_tail=stdout[-300:], stderr_tail=stderr[-600:], card=card)
            if proc.returncode != 0 or img is None or img.shape != (64, 96, 3) or not img.max() > 0:
                raise AssertionError(f"cli_preset {model}: exit {proc.returncode}: {stderr[-2000:]}")
            if imported != [[]]:
                raise AssertionError(f"cli_preset {model}: the child imported {imported}")

    return finish


DIST_RANKS = 2  # gloo ranks sharing cuda:0: NCCL cannot put two ranks on one card
DIST_FRAMES = 2  # frames of each distributed strip render (the first pays the ranks' warm-up)
DIST_TOL = dict(rtol=2e-4, atol=2e-5)  # __graft_entry__.py:191, sharded against one device
DIST_FOV_TOL = dict(rtol=1e-6, atol=1e-6)  # tests/test_parallel_foveated.py:51-52
DIST_GAZES = ((1920, 1080), (1400, 700))  # image coordinates of the 4K frames: centre, then moved
DIST_TIMEOUT_S = 300
BALANCE_GATE = 0.10  # per-rank rays within 10 % of the mean (__graft_entry__.py:125-127)


def dist_gloo_program(rank, world, device, programs):
    """The gloo ranks' three paths in one spawn (each rank builds its own
    scenes): `programs` maps a name to (rank program of parallel/dryrun,
    args, kwargs). Ranks past 0 return their frames as digests, which the
    parent holds equal to rank 0's frames."""
    out = {}
    for name, (fn, args, kwargs) in programs.items():
        res = fn(rank, world, device, *args, **kwargs)
        for key in ("image", "images"):
            if key in res and rank:
                imgs = res.pop(key)
                res[key + "_sha256"] = [_sha(i) for i in (imgs if key == "images" else [imgs])]
        out[name] = res
    return out


def _sha(img) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _rank_checks(phase, res, walk_name):
    """Per-rank gates every distributed path shares: the port only
    imported, every rank launched its walk's kernels, and the rank frames
    equal rank 0's."""
    for r in res:
        if r["imported"]:
            raise AssertionError(f"{phase}: rank {r['rank']} imported {r['imported']}")
        check_walk(f"{phase} rank {r['rank']}", r["launch_counts"], walk_name)
    for r in res[1:]:
        want = [_sha(i) for i in (res[0]["images"] if "images" in res[0] else [res[0]["image"]])]
        got = r.get("images_sha256", r.get("image_sha256"))
        if got != want:
            raise AssertionError(f"{phase}: rank {r['rank']} gathered another frame than rank 0")


def _summed_launches(res) -> dict:
    total = {}
    for r in res:
        for k, v in r["launch_counts"].items():
            total[k] = total.get(k, 0) + v
    return total


def _strip_gates(phase, res, want, tol, card, **fields):
    """Emit a strip-parallel path's line and hold it: the frame against the
    single-device one, the ranks' rays summing to `last_rays`, the strip
    balance within BALANCE_GATE."""
    from optixpathtracer_tpu_torch.parallel.dryrun import imbalance

    got = res[0]
    dev_rays = np.asarray(got["rays_per_device"])
    diff = float(np.abs(got["image"] - want).max())
    imb = imbalance(dev_rays)
    emit(phase, ranks=len(res), frames=len(got["frame_s"]), max_abs_diff=diff, tol=tol,
         rays=got["rays"], rays_per_rank=dev_rays.tolist(), balance=imb, balance_gate=BALANCE_GATE,
         frame_s_per_rank=[r["frame_s"] for r in res], gather_ms_per_rank=[r["gather_ms"] for r in res],
         launches_per_rank=[r["launch_counts"] for r in res], card=card, **fields)
    if not np.allclose(got["image"], want, **tol):
        raise AssertionError(f"{phase}: the sharded frame differs from one device's by {diff}")
    if int(dev_rays.sum()) != int(got["rays"]) or imb > BALANCE_GATE:
        raise AssertionError(f"{phase}: rays per rank {dev_rays.tolist()} (sum {dev_rays.sum()}, "
                             f"last_rays {got['rays']}), imbalance {imb}")


def dist_phases(cs, probe, dev, card):
    """Strip and lane sharding over `torch.distributed` (parallel/), each
    path against its single-device render on this card:

    - `dist_city`: the city slice (disney_pt, 1200x800, 2 spp, depth 4, the
      bench's flags, the node walk) through `DistributedRenderer` over
      DIST_RANKS gloo ranks on cuda:0, at DIST_TOL;
    - `dist_fov4k`: the sv4 preset as published (3840x2160 fused) through
      `DistributedFoveatedRenderer` over the same ranks and a gaze move, at
      DIST_FOV_TOL;
    - `dist_demand`: bench.py's loft row from a one-level pool of 128
      tiles per rank: `pages_loaded` equal to one device's demand run,
      the settled frame equal to the resident render within DEMAND_TOL;
    - `dist_nccl`: the city slice over NCCL at world size 1;
    - `dryrun`: `python -m optixpathtracer_tpu_torch.parallel.dryrun
      --ranks 2 --device cuda:0` in a child process (gloo), started first
      and run beside the rest (its checks are of rays and images; the
      ranks' frame times above are read beside it).

    Launch counts are each rank's, cleared just before its distributed
    frames and read just after. Returns ({path: launches summed over
    ranks}, {path: each rank's launches})."""
    import shutil

    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.io.obj import load_obj
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer, make_foveated_renderer
    from optixpathtracer_tpu_torch.parallel import ranks
    from optixpathtracer_tpu_torch.parallel.dryrun import foveated_program, imbalance, strip_program

    t_all = time.perf_counter()
    dryrun = _popen([sys.executable, "-m", "optixpathtracer_tpu_torch.parallel.dryrun", "--ranks", "2",
                     "--device", "cuda:0", "--timeout", str(DIST_TIMEOUT_S)])
    # ---- the single-device references on this card
    city = make_disney_pt_renderer(cs, probe, scenes.city_camera(WIDTH, HEIGHT), width=WIDTH, height=HEIGHT,
                                   spp=SPP, max_depth=DEPTH, **BENCH_FLAGS)
    for _ in range(DIST_FRAMES):
        city.render(download=False)
    city_img = city.accum_image()
    fov = make_foveated_renderer(cs, probe, scenes.city_camera(FOV_4K["width"], FOV_4K["height"]),
                                 **FOV_4K, **BENCH_FLAGS)
    if not fov.fused:
        raise AssertionError("the 4K preset's default route no longer fuses its zones")
    fov_imgs, fov_rays = [], []
    for g in DIST_GAZES:
        fov.set_gaze(*g)
        fov.render(download=False)
        fov_imgs.append(fov.accum_image())
        fov_rays.append(fov.last_rays)
    loft_hs = load_obj(scenes.LOFT_OBJ)
    loft_setup = scenes.loft_config(WIDTH, HEIGHT, dev)
    resident = make_disney_pt_renderer(compile_scene(loft_hs, dev, **CITY_BUILD), loft_setup.probe,
                                       loft_setup.camera, width=WIDTH, height=HEIGHT, spp=SPP,
                                       max_depth=DEPTH, **loft_setup.flags)
    resident.render(download=False)
    loft_img = resident.accum_image()
    programs = {
        "city": (strip_program, (scenes.build_city_scene, scenes.city_sky, city.config, city.camera),
                 dict(frames=DIST_FRAMES, build=CITY_BUILD)),
        "fov": (foveated_program, (scenes.build_city_scene, scenes.city_sky, fov.config, fov.camera,
                                   fov.fov, DIST_GAZES), dict(build=CITY_BUILD)),
        "loft": (strip_program, (loft_hs, scenes.dark_probe, resident.config, resident.camera),
                 dict(demand=dict(capacity=128, levels=1), build=CITY_BUILD, single=True)),
    }
    ref_s = time.perf_counter() - t_all
    del city, fov, resident
    torch.cuda.empty_cache()

    # ---- DIST_RANKS gloo ranks on this card: the city, the 4K lanes, the loft's pool
    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    try:
        res = ranks.run_ranks(dist_gloo_program, DIST_RANKS, "gloo", "cuda:0", os.path.join(tmp, "gloo"),
                              args=(programs,), timeout_s=DIST_TIMEOUT_S)
        gloo_s = time.perf_counter() - t0
        (nccl,) = ranks.run_ranks(strip_program, 1, "nccl", "cuda:0", os.path.join(tmp, "nccl"),
                                  args=programs["city"][1], kwargs=programs["city"][2],
                                  timeout_s=DIST_TIMEOUT_S)
        nccl_s = time.perf_counter() - t0 - gloo_s
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {}
    city_res = [r["city"] for r in res]
    _rank_checks("dist_city", city_res, "node")
    _strip_gates("dist_city", city_res, city_img, DIST_TOL, card, backend="gloo", device="cuda:0",
                 spawn_s=gloo_s, flags=BENCH_FLAGS)
    launches["dist_city"] = _summed_launches(city_res)

    fov_res = [r["fov"] for r in res]
    _rank_checks("dist_fov4k", fov_res, "node")
    got = fov_res[0]
    diffs = [float(np.abs(a - b).max()) for a, b in zip(got["images"], fov_imgs)]
    imbs = [imbalance(d) for d in got["rays_per_device"]]
    emit("dist_fov4k", **FOV_4K, ranks=DIST_RANKS, backend="gloo", gazes=DIST_GAZES, max_abs_diff=diffs,
         tol=DIST_FOV_TOL, rays=got["rays"], single_rays=fov_rays,
         rays_per_rank=[np.asarray(d).tolist() for d in got["rays_per_device"]], balance=imbs,
         balance_gate=BALANCE_GATE, frame_s_per_rank=[r["frame_s"] for r in fov_res],
         launches_per_rank=[r["launch_counts"] for r in fov_res], card=card)
    if not all(np.allclose(a, b, **DIST_FOV_TOL) for a, b in zip(got["images"], fov_imgs)):
        raise AssertionError(f"dist_fov4k: the sharded lanes differ from the fused frame by {diffs}")
    if got["rays"] != fov_rays or max(imbs) > BALANCE_GATE:
        raise AssertionError(f"dist_fov4k: rays {got['rays']} against {fov_rays}, imbalance {imbs}")
    launches["dist_fov4k"] = _summed_launches(fov_res)

    loft_res = [r["loft"] for r in res]
    _rank_checks("dist_demand", loft_res, "flat")
    got = loft_res[0]
    _strip_gates("dist_demand", loft_res, loft_img, dict(rtol=0.0, atol=DEMAND_TOL), card, backend="gloo",
                 pages_loaded=got["pages_loaded"], single_pages_loaded=got["single_pages_loaded"],
                 pages_per_rank=[r["pages_loaded"] for r in loft_res], settle_launches=got["launches"],
                 single_frame_s=got["single_frame_s"])
    if not (got["pages_loaded"] == got["single_pages_loaded"] > 0
            and all(r["pages_loaded"] == got["pages_loaded"] for r in loft_res)):
        raise AssertionError(f"dist_demand: pages loaded {[r['pages_loaded'] for r in loft_res]}, "
                             f"one device {got['single_pages_loaded']}")
    launches["dist_demand"] = _summed_launches(loft_res)

    # ---- NCCL at world size 1 (its init and collectives) on the city slice
    _rank_checks("dist_nccl", [nccl], "node")
    _strip_gates("dist_nccl", [nccl], city_img, DIST_TOL, card, backend="nccl", device="cuda:0",
                 spawn_s=nccl_s)
    launches["dist_nccl"] = dict(nccl["launch_counts"])

    # ---- the dry run, as a user runs it, on this card (started above)
    stdout, stderr = _wait(dryrun, DIST_TIMEOUT_S + 60)
    lines = stdout.strip().splitlines()
    ok = dryrun.returncode == 0 and len(lines) >= 2 and lines[-2].startswith("dryrun_multichip(2): ok")
    info = json.loads(lines[-1]) if ok else {}
    emit("dryrun", returncode=dryrun.returncode, summary=lines[-2] if ok else None,
         launches_per_rank=info.get("launches_per_rank"), seconds_since_dist_start=time.perf_counter() - t_all,
         stderr_tail=None if ok else stderr[-2000:], card=card)
    if not ok:
        raise AssertionError(f"the dry run failed (exit {dryrun.returncode}): {stdout[-500:]} {stderr[-2000:]}")
    per_rank = {"dist_city": [r["launch_counts"] for r in city_res],
                 "dist_fov4k": [r["launch_counts"] for r in fov_res],
                 "dist_demand": [r["launch_counts"] for r in loft_res],
                 "dist_nccl": [nccl["launch_counts"]], "dryrun": []}
    for rank in info["launches_per_rank"]:
        counts = {}
        for mode in rank.values():
            for k, v in mode.items():
                counts[k] = counts.get(k, 0) + v
        per_rank["dryrun"].append(counts)
    launches["dryrun"] = _summed_launches([{"launch_counts": c} for c in per_rank["dryrun"]])
    emit("dist_phases", seconds=time.perf_counter() - t_all, references_s=ref_s, gloo_spawn_s=gloo_s, card=card)
    return launches, per_rank


JPEG_QUALITY = 90  # the loft's textures re-encoded by the port's encode_jpeg at this quality
JPEG_PSNR_MIN = 25.0  # dB of a decoded image against its source: the codec round trip is sane (garbage reads ~10)
JPEG_DECODE_SIZE = 2048  # the timed host decode: one 2048x2048 JPEG
JPEG_RENDER = dict(width=160, height=100, spp=2, max_depth=4)  # card against the CPU (~1.5 s on the CPU)
JPEG_RENDER_TOL = 1e-4  # sqrt-space RMSE, card against CPU (DEMAND_WINDOW_TOL's textured bound)


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def jpeg_scene(dev, card, counts):
    """The loft with its three PNG textures re-encoded as JPEG by the
    port's own `encode_jpeg` (this machine has no PIL) and its MTL pointing
    at them, loaded through `load_obj` (the new decoder): each texture
    against its PNG (PSNR), the texture fetch card == CPU bit for bit, the
    render at JPEG_RENDER on the card against the port's CPU render; and
    one 2048x2048 JPEG decoded on this machine's host, timed. Returns the
    card render's launches."""
    import shutil

    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.io.image import encode_jpeg, read_rgb8, rgb8_from_bytes
    from optixpathtracer_tpu_torch.io.obj import load_obj
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(scenes.LOFT_OBJ, tmp)
        mtl = open(os.path.join(REPO, "scenes", "loft.mtl")).read()
        psnr, sizes, decode_ms = {}, {}, {}
        for name in LOFT_PNG_SUMS:
            png = read_rgb8(os.path.join(REPO, "scenes", name))
            data = encode_jpeg(torch.as_tensor(png, device=dev), JPEG_QUALITY)
            jpg = name.replace(".png", ".jpg")
            with open(os.path.join(tmp, jpg), "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            back = rgb8_from_bytes(data)
            decode_ms[jpg] = (time.perf_counter() - t0) * 1e3
            psnr[jpg], sizes[jpg] = _psnr(back, png), len(data)
            mtl = mtl.replace(name, jpg)
        with open(os.path.join(tmp, "loft.mtl"), "w") as f:
            f.write(mtl)
        hs = load_obj(os.path.join(tmp, "loft.obj"))
    mismatches, fetch_diff = texture_fetch_card_eq(hs, dev)
    launches = {}
    w, h = JPEG_RENDER["width"], JPEG_RENDER["height"]
    imgs, frame_s = {}, {}
    for d in (dev, torch.device("cpu")):
        setup = scenes.loft_config(w, h, d)
        r = make_disney_pt_renderer(compile_scene(hs, d, **CITY_BUILD), setup.probe, setup.camera,
                                    width=w, height=h, spp=JPEG_RENDER["spp"],
                                    max_depth=JPEG_RENDER["max_depth"], traversal="cluster", **setup.flags)
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts.clear()
        t0 = time.perf_counter()
        r.render(download=False)
        frame_s[str(d)] = time.perf_counter() - t0
        if d.type == "cuda":
            launches = dict(counts)
        imgs[str(d)] = r.accum_image()
    rmse = scenes.golden_rmse(imgs[str(dev)], imgs["cpu"])
    # one 2048x2048 JPEG: smooth gradients and seeded noise, encoded on the card
    rng = np.random.default_rng(JPEG_DECODE_SIZE)
    y, x = np.mgrid[0:JPEG_DECODE_SIZE, 0:JPEG_DECODE_SIZE]
    big = np.clip(np.stack([128 + 100 * np.sin(x / 37.0 + y / 51.0), 128 + 90 * np.cos(x / 25.0 - y / 33.0),
                            (x + y) % 256], -1) + rng.normal(0, 8, x.shape + (3,)), 0, 255).astype(np.uint8)
    data = encode_jpeg(torch.as_tensor(big, device=dev), JPEG_QUALITY)
    t0 = time.perf_counter()
    back = rgb8_from_bytes(data)
    big_s = time.perf_counter() - t0
    big_psnr = _psnr(back, big)
    emit("jpeg_scene", quality=JPEG_QUALITY, texture_psnr_db=psnr, jpeg_bytes=sizes, decode_ms=decode_ms,
         textures=[list(t.shape) for t in hs.textures], fetch_mismatches=mismatches,
         fetch_max_abs_diff=fetch_diff, **JPEG_RENDER, frame_s=frame_s, rmse_card_vs_cpu=rmse,
         tol=JPEG_RENDER_TOL, launches=launches, decode_2048=dict(bytes=len(data), seconds=big_s,
                                                                   psnr_db=big_psnr),
         seconds=time.perf_counter() - t_all, card=card)
    check_walk("jpeg_scene", launches, "flat")
    if len(hs.textures) != 3 or min(psnr.values()) < JPEG_PSNR_MIN or big_psnr < JPEG_PSNR_MIN:
        raise AssertionError(f"jpeg_scene: {len(hs.textures)} textures, PSNR {psnr}, 2048^2 {big_psnr}")
    if mismatches or not rmse <= JPEG_RENDER_TOL:
        raise AssertionError(f"jpeg_scene: {mismatches} fetches differ card against CPU, "
                             f"render RMSE {rmse} (limit {JPEG_RENDER_TOL})")
    return launches


CODEC_FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "textures")
CODEC_LOSSLESS = {"loft_tex0.png": "loft_tex0.tga", "loft_tex1.png": "loft_tex1.tif",
                  "loft_tex2.png": "loft_tex2.webp"}  # tests/torch_fixtures/make_textures.py's sets
CODEC_LOSSY = {"loft_tex0.png": "loft_tex0_lossy.webp", "loft_tex1.png": "loft_tex1_bc1.dds",
               "loft_tex2.png": "loft_tex2_arith.jpg"}
CODEC_LOSSLESS2 = {"loft_tex0.png": "loft_tex0.dcx", "loft_tex1.png": "loft_tex1_orient5_lzma.tif",
                   "loft_tex2.png": "loft_tex2.icns"}  # DCX, an LZMA TIFF stored transposed, ICNS
CODEC_LOSSLESS3 = {"loft_tex0.png": "loft_tex0_53.jp2", "loft_tex1.png": "loft_tex1_rpcl_tiles.j2k",
                   "loft_tex2.png": "loft_tex2_j2k.icns"}  # JPEG 2000: 5/3 JP2, tiled RPCL, an ICNS entry
CODEC_LOSSY2 = {"loft_tex0.png": "loft_tex0.avif", "loft_tex1.png": "loft_tex1.avif",
                "loft_tex2.png": "loft_tex2.avif"}  # AVIF at PIL's defaults: palette, IntraBC
# AVIF with PIL's save options: 4:4:4 with CDEF at speed 4, a premultiplied
# RGBA at speed 2 with loop restoration, 4:2:2
CODEC_LOSSY3 = {"loft_tex0.png": "loft_tex0_444_cdef.avif", "loft_tex1.png": "loft_tex1_rgba_prem_lr.avif",
                "loft_tex2.png": "loft_tex2_422.avif"}
CODEC_LOSSY_SETS = ("lossy", "lossy2", "lossy3")  # each card frame against its CPU frame
CODEC_LOSSLESS_SETS = ("lossless", "lossless2", "lossless3")
# AVIF files the port refuses (step-3 variants, and what PIL refuses):
# name -> the exception class name and message pattern
CODEC_AVIF_RAISES = os.path.join(REPO, "tests", "torch_fixtures", "avif_raises")


def _loft_textured(tmp, names: dict):
    """The loft's OBJ in `tmp` with its MTL's textures renamed to `names`'
    fixtures (copied beside it), loaded through `load_obj`."""
    import shutil

    from optixpathtracer_tpu_torch.io.obj import load_obj

    shutil.copy(os.path.join(REPO, "scenes", "loft.obj"), tmp)
    mtl = open(os.path.join(REPO, "scenes", "loft.mtl")).read()
    for png, name in names.items():
        shutil.copy(os.path.join(CODEC_FIXTURES, name) if name != png else os.path.join(REPO, "scenes", png), tmp)
        mtl = mtl.replace(png, name)
    with open(os.path.join(tmp, "loft.mtl"), "w") as f:
        f.write(mtl)
    return load_obj(os.path.join(tmp, "loft.obj"))


def _loft_frame(hs, device, counts=None):
    """The loft at JPEG_RENDER (scenes.loft_config's camera and probe,
    the cluster traversal) -> (the accumulated image, the launches of the
    render if `counts`, frame seconds)."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer

    w, h = JPEG_RENDER["width"], JPEG_RENDER["height"]
    setup = scenes.loft_config(w, h, device)
    r = make_disney_pt_renderer(compile_scene(hs, device, **CITY_BUILD), setup.probe, setup.camera, width=w,
                                height=h, spp=JPEG_RENDER["spp"], max_depth=JPEG_RENDER["max_depth"],
                                traversal="cluster", **setup.flags)
    if device.type == "cuda":
        torch.cuda.synchronize()
        if counts is not None:
            counts.clear()
    t0 = time.perf_counter()
    r.render(download=False)
    img = r.accum_image()
    seconds = time.perf_counter() - t0
    return img, (dict(counts) if counts is not None else {}), seconds


def _avif_step6(data: bytes) -> dict:
    """The AVIF step-6 variants an AVIF fixture uses, read from its boxes
    and headers: superres, more than one frame in the item, a frame or an
    alpha item of another size than its ispe (tkhd), limited-range
    premultiplied alpha, and the track as its source."""
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif

    image, _, alpha, premultiplied = avif._read(data)

    def headers(obus):
        seq, frames = None, []
        for k, p in av1_obu.split_obus(obus):
            if k == av1_obu.OBU_SEQUENCE_HEADER:
                seq = av1_obu.sequence_header(p)
            elif k in (av1_obu.OBU_FRAME, av1_obu.OBU_FRAME_HEADER):
                frames.append(p)
        return seq, av1_obu.frame_header(av1_obu.Bits(frames[0]), seq), len(frames)
    seq, h, n = headers(image.cells[0])
    scaled = image.grid is None and (h["upscaled_width"], h["height"]) != tuple(image.ispe)
    limited = False
    if alpha is not None and alpha.grid is None:
        aseq, ah, _ = headers(alpha.cells[0])
        scaled |= (ah["upscaled_width"], ah["height"]) != tuple(alpha.ispe)
        limited = premultiplied and not aseq["color_range"]
    tracks = avif.brands(data)[0] == b"avis" or all(k != b"meta" for k, _, _ in avif._boxes(data, 0, len(data)))
    return {"superres": h["upscaled_width"] != h["width"], "frames": n > 1, "scaled": scaled,
            "limited_alpha": limited, "tracks": tracks}


def _avif_step7(data: bytes) -> bool:
    """Whether an AVIF fixture's item holds an AV1 inter frame (AVIF step
    7), read from its frame headers as the decoder reads them."""
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif

    image = avif._read(data)[0]
    return any(h.get("frame_type") == av1_obu.INTER_FRAME for cell in image.cells
               for h in av1_obu.frame_headers(cell))


def codecs_scene(dev, card, counts):
    """The port's own decoders of the texture formats beyond PNG and JPEG,
    on a machine without PIL: every fixture against tests/torch_fixtures/
    textures/manifest.json (PIL's decode: shape, channel sums, SHA-256),
    timed on the host; the loft with three lossless sets of formats (each
    set's texture arrays equal to the PNG loft's, its card frame equal to
    the PNG loft's card frame bit for bit, its launches the PNG loft's) and
    three lossy sets (WebP / DDS / arithmetic JPEG, AVIF at PIL's defaults,
    and AVIF with PIL's options: each card frame against its CPU frame
    within JPEG_RENDER_TOL, the AVIF sets' launches the PNG loft's); K1 /
    K2 / K3 on the flat walk in every card render; the AVIF files the port
    refuses raise what tests/torch_fixtures/avif_raises/expected.json says.
    Reports the 10- and 12-bit AVIF fixtures' count and host decode ms
    (total, largest), the count and host decode ms (total, largest) of the
    AVIF fixtures using each AVIF step-4 tool (film grain applied,
    quantizer matrices, delta q, delta lf; read from their frame headers),
    the same of the fixtures using each AVIF step-5 variant (AV1
    segmentation, a grid item, a matrix libavif converts without libyuv;
    read from their headers), the same of the fixtures using each AVIF
    step-6 variant (superres, more than one frame in the item, a frame or
    alpha scaled to its ispe, limited-range premultiplied alpha, a track
    read as libavif reads it; _avif_step6), the same of the fixtures
    holding an AV1 inter frame (AVIF step 7; _avif_step7) with the 1024 x
    1024 one's, the refusals' count, and the 8-bit 1024 x 1024 one's. Returns the three lossless loft
    renders' launches and the two AVIF lofts'."""
    import hashlib

    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif, avif_yuv
    from optixpathtracer_tpu_torch.io.image import rgb8_from_bytes

    t_all = time.perf_counter()
    with open(os.path.join(CODEC_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    decode_ms, bad, avif_depth, avif_tools, avif_step6, avif_step7 = {}, [], {}, {}, {}, {}
    for name, entry in sorted(manifest.items()):
        with open(os.path.join(CODEC_FIXTURES, name), "rb") as f:
            data = f.read()
        if name.endswith(".avif"):
            obus, colour = avif.parse(data)
            seq = None
            for k, p in av1_obu.split_obus(obus):
                if k == av1_obu.OBU_SEQUENCE_HEADER:
                    seq = av1_obu.sequence_header(p)
                elif k in (av1_obu.OBU_FRAME, av1_obu.OBU_FRAME_HEADER):
                    h = av1_obu.frame_header(av1_obu.Bits(p), seq)
                    break
            avif_depth[name] = seq["bit_depth"]
            matrix, _, primaries = avif._colour(colour, seq)
            avif_tools[name] = {"grain": h["grain"]["apply_grain"], "qm": h["using_qmatrix"],
                                "delta_q": h["delta_q_present"], "delta_lf": h["delta_lf_present"],
                                "segmentation": h["segmentation_enabled"], "grid": avif._read(data)[0].grid is not None,
                                "own_matrix": avif_yuv.libyuv_matrix(matrix, primaries, seq["mono"]) is None}
            avif_step6[name] = _avif_step6(data)
            avif_step7[name] = _avif_step7(data)
        t0 = time.perf_counter()
        rgb = rgb8_from_bytes(data)
        decode_ms[name] = (time.perf_counter() - t0) * 1e3
        got = [list(rgb.shape), rgb.reshape(-1, 3).sum(0, dtype=np.int64).tolist(),
               hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()]
        if got != [entry["shape"], entry["sums"], entry["sha256"]]:
            bad.append(name)
    with open(os.path.join(CODEC_AVIF_RAISES, "expected.json")) as f:
        avif_raises = json.load(f)
    refused_wrongly = []
    for name, want in sorted(avif_raises.items()):
        with open(os.path.join(CODEC_AVIF_RAISES, name), "rb") as f:
            data = f.read()
        try:
            rgb8_from_bytes(data)
            refused_wrongly.append(f"{name}: decoded")
        except Exception as e:  # noqa: BLE001 -- the refusal is what is checked
            if type(e).__name__ != want["raises"] or not re.search(want["match"], str(e)):
                refused_wrongly.append(f"{name}: {type(e).__name__}: {e}")
    avif_ms = {n: ms for n, ms in decode_ms.items() if n.endswith(".avif")}
    hbd_ms = {n: ms for n, ms in avif_ms.items() if avif_depth[n] > 8}
    tool_ms = {tool: [ms for n, ms in avif_ms.items() if avif_tools[n][tool]]
               for tool in ("grain", "qm", "delta_q", "delta_lf")}
    step5_ms = {variant: [ms for n, ms in avif_ms.items() if avif_tools[n][variant]]
                for variant in ("segmentation", "grid", "own_matrix")}
    step6_ms = {variant: [ms for n, ms in avif_ms.items() if avif_step6[n][variant]]
                for variant in ("superres", "frames", "scaled", "limited_alpha", "tracks")}
    step7_ms = [ms for n, ms in avif_ms.items() if avif_step7[n]]
    scenes_by_kind, t_load = {}, {}
    for kind, names in (("png", {png: png for png in CODEC_LOSSLESS}), ("lossless", CODEC_LOSSLESS),
                        ("lossless2", CODEC_LOSSLESS2), ("lossless3", CODEC_LOSSLESS3), ("lossy", CODEC_LOSSY),
                        ("lossy2", CODEC_LOSSY2), ("lossy3", CODEC_LOSSY3)):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            scenes_by_kind[kind] = _loft_textured(tmp, names)
            t_load[kind] = time.perf_counter() - t0
    png_tex = scenes_by_kind["png"].textures
    equal_textures = {kind: len(scenes_by_kind[kind].textures) == len(png_tex) == 3 and all(
        np.array_equal(a, b) for a, b in zip(scenes_by_kind[kind].textures, png_tex))
        for kind in CODEC_LOSSLESS_SETS}
    frames, launches, frame_s = {}, {}, {}
    for kind in ("lossless", "png", "lossless2", "lossless3") + CODEC_LOSSY_SETS:
        frames[kind], launches[kind], frame_s[kind] = _loft_frame(scenes_by_kind[kind], dev, counts)
        check_walk(f"codecs_scene ({kind})", launches[kind], "flat")
    rmse = {}
    for kind in CODEC_LOSSY_SETS:
        cpu, _, frame_s[f"{kind}_cpu"] = _loft_frame(scenes_by_kind[kind], torch.device("cpu"))
        rmse[kind] = scenes.golden_rmse(frames[kind], cpu)
    card_eq = {kind: bool(np.array_equal(frames[kind], frames["png"])) for kind in CODEC_LOSSLESS_SETS}
    emit("codecs_scene", fixtures=len(manifest), mismatched=bad, decode_ms=decode_ms,
         decode_ms_total=sum(decode_ms.values()), avif_fixtures=len(avif_ms),
         avif_decode_ms_total=sum(avif_ms.values()), avif_decode_ms_max=max(avif_ms.values(), default=0.0),
         avif_hbd_fixtures=len(hbd_ms), avif_hbd_decode_ms_total=sum(hbd_ms.values()),
         avif_hbd_decode_ms_max=max(hbd_ms.values(), default=0.0),
         avif_tool_fixtures={t: len(v) for t, v in tool_ms.items()},
         avif_tool_decode_ms_total={t: sum(v) for t, v in tool_ms.items()},
         avif_tool_decode_ms_max={t: max(v, default=0.0) for t, v in tool_ms.items()},
         avif_step5_fixtures={t: len(v) for t, v in step5_ms.items()},
         avif_step5_decode_ms_total={t: sum(v) for t, v in step5_ms.items()},
         avif_step5_decode_ms_max={t: max(v, default=0.0) for t, v in step5_ms.items()},
         avif_step6_fixtures={t: len(v) for t, v in step6_ms.items()},
         avif_step6_decode_ms_total={t: sum(v) for t, v in step6_ms.items()},
         avif_step6_decode_ms_max={t: max(v, default=0.0) for t, v in step6_ms.items()},
         avif_step7_fixtures=len(step7_ms), avif_step7_decode_ms_total=sum(step7_ms),
         avif_step7_decode_ms_max=max(step7_ms, default=0.0),
         avif_step7_1024_decode_ms=decode_ms.get("avif_inter_1024.avif"),
         avif_1024_decode_ms=decode_ms.get("avif_1024_tiles.avif"), avif_refused=len(avif_raises),
         avif_refused_wrongly=refused_wrongly, load_obj_s=t_load, loft_textures_equal_png=equal_textures,
         lossless_frame_equals_png_frame=card_eq, lossy_rmse_card_vs_cpu=rmse["lossy"],
         lossy2_rmse_card_vs_cpu=rmse["lossy2"], lossy3_rmse_card_vs_cpu=rmse["lossy3"],
         tol=JPEG_RENDER_TOL, **JPEG_RENDER, frame_s=frame_s, launches=launches,
         seconds=time.perf_counter() - t_all, card=card)
    if bad:
        raise AssertionError(f"codecs_scene: fixtures decoded unlike PIL: {bad}")
    if refused_wrongly:
        raise AssertionError(f"codecs_scene: AVIF files not refused as expected: {refused_wrongly}")
    if not step7_ms:
        raise AssertionError("codecs_scene: no AVIF fixture holds an AV1 inter frame")
    for kind in CODEC_LOSSLESS_SETS:
        if not equal_textures[kind]:
            raise AssertionError(f"codecs_scene: the {kind} loft's textures differ from the PNG loft's")
        if not card_eq[kind]:
            raise AssertionError(f"codecs_scene: the {kind} loft's card frame differs from the PNG loft's")
        if launches[kind] != launches["png"]:
            raise AssertionError(f"codecs_scene: the {kind} loft's launches {launches[kind]} are not the PNG "
                                 f"loft's {launches['png']}")
    for kind in CODEC_LOSSY_SETS:
        if not rmse[kind] <= JPEG_RENDER_TOL:
            raise AssertionError(f"codecs_scene: the {kind} loft's card frame against its CPU frame RMSE "
                                 f"{rmse[kind]} (limit {JPEG_RENDER_TOL})")
    for kind in ("lossy2", "lossy3"):
        if launches[kind] != launches["png"]:
            raise AssertionError(f"codecs_scene: the {kind} (AVIF) loft's launches {launches[kind]} are not the "
                                 f"PNG loft's {launches['png']}")
    return tuple(launches[kind] for kind in CODEC_LOSSLESS_SETS + ("lossy2", "lossy3"))


# ---- the scripts beside the package, as modules of the port ---------------

SCRIPTS_TIMEOUT_S = 420
_SCRIPT_CHILD = """import json, runpy, sys
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
rc = 0
for module, argv in json.loads(sys.argv[1]):
    tc.launch_counts.clear()
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = rc or (e.code or 0)
    print("LAUNCHES " + json.dumps([module, argv, dict(tc.launch_counts)]), flush=True)
print("IMPORTED " + json.dumps([m for m in ("jax", "optixpathtracer_tpu", "PIL") if m in sys.modules]))
sys.exit(rc)
"""
FPS_FRAMES, FPS_UNI_FRAMES = 10, 1  # tools/fps_harness.py's --frames (its default) and --uni-frames
#   (its default 3: a uniform frame at 1200x800, 8 spp, depth 4 takes some 6 s)
SESSION_FRAMES = 16
REF_SPP = (8, 64)  # make_reference at 600x400: its RMSE must fall from the first to the second
DISC_SPP = 16  # make_reference_4k's fovea disc
EXAMPLE_SHAPES = {"render_loft": (320, 480), "render_cornell": (256, 256), "render_foveated": (360, 480),
                  "demand_textures_demo": (400, 640)}  # the examples' own sizes, (H, W)


def _npz_rmse(got, want_path):
    """sqrt-space RMSE of an image array against a committed npz's image,
    and the npz's keys."""
    from optixpathtracer_tpu_torch import scenes

    want = np.load(want_path)
    return scenes.golden_rmse(got.astype(np.float32), want["image"].astype(np.float32)), set(want.files)


def _tool_outputs(stdout):
    """Each run's stdout lines and launches: [(module, argv, lines, launches)]."""
    runs, lines = [], []
    for ln in stdout.splitlines():
        if ln.startswith("LAUNCHES "):
            module, argv, launches = json.loads(ln.split(" ", 1)[1])
            runs.append((module, argv, lines, launches))
            lines = []
        else:
            lines.append(ln)
    return runs


def _seconds_per_spp(lines, prefix):
    """Seconds per spp from a reference generator's '<prefix> N spp in X s' line."""
    for ln in lines:
        if ln.startswith(prefix) and " spp in " in ln:
            n, sec = ln[len(prefix):].split(" spp in ")
            return float(sec.rstrip("s")) / int(n.split()[-1])
    raise AssertionError(f"no '{prefix}' timing line in {lines[-5:]}")


SCRIPT_GROUPS = {  # a child process each; only "measured" reads frame rates, and runs alone
    "measured": ("fps_harness", "interactive_session"),
    "references": ("make_reference", "make_reference_4k"),
    "examples": tuple(EXAMPLE_SHAPES),
}


def scripts_phase(card, tmp, group):
    """The eight scripts beside the package as the port's modules, each as
    `python -m` runs it, in a child process on the card (its launches
    counted from 0 before each run and read after it; no jax, JAX package or
    PIL imported), one group of SCRIPT_GROUPS, started now. "measured", the
    two whose frame rates are measured, to run alone: `tools.fps_harness` at
    1200x800 (10 foveated and 1 uniform frame: the TSVs' columns and rows,
    every frame's rays above 0, each foveated frame tracing fewer rays than
    each uniform one, both modes' fps and their ratio) and
    `tools.interactive_session --frames 16`. The others may run beside
    other children: "references", `tools.make_reference` at 600x400 with
    --spp 8 and --spp 64 (the committed npz's keys; sqrt-space RMSE against
    scenes/ref_city_600x400.npz, which must fall from 8 to 64 spp; seconds
    per spp) and `tools.make_reference_4k --disc-spp 16 --skip-q` (the
    disc's pixels and RMSE against scenes/ref_city_4k_fovea.npz; its box
    downsample checked here on a small array); "examples", the four
    examples at their own sizes (a PNG of its size, not black, read by the
    port's decoder; the demand demo's resident pages below the texture's).
    Outputs go under tmp. Returns a function that waits for the child,
    checks its runs and returns {path: launches}."""
    from optixpathtracer_tpu_torch.io.image import read_rgb8
    from optixpathtracer_tpu_torch.tools.make_reference_4k import box_downsample

    def j(*parts):
        return os.path.join(tmp, *parts)

    plan = [
        ("optixpathtracer_tpu_torch.tools.fps_harness",
         ["--uni-frames", str(FPS_UNI_FRAMES), "--out", j("fps")]),
        ("optixpathtracer_tpu_torch.tools.interactive_session",
         ["--frames", str(SESSION_FRAMES), "--out", j("session.tsv")]),
        *[("optixpathtracer_tpu_torch.tools.make_reference", ["--spp", str(n), "--out-dir", j(f"ref{n}")])
          for n in REF_SPP],
        ("optixpathtracer_tpu_torch.tools.make_reference_4k",
         ["--disc-spp", str(DISC_SPP), "--skip-q", "--out-dir", j("ref4k")]),
        *[(f"optixpathtracer_tpu_torch.examples.{name}", [j(f"{name}.png")]) for name in EXAMPLE_SHAPES],
    ]
    plan = [(m, a) for m, a in plan if m.rsplit(".", 1)[1] in SCRIPT_GROUPS[group]]
    t0 = time.perf_counter()
    proc = _popen([sys.executable, "-c", _SCRIPT_CHILD, json.dumps(plan)])

    def finish():
        stdout, stderr = _wait(proc, SCRIPTS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        runs = _tool_outputs(stdout)
        imported = [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines() if ln.startswith("IMPORTED ")]
        if proc.returncode != 0 or len(runs) != len(plan) or imported != [[]]:
            emit("scripts", returncode=proc.returncode, imported=imported, stdout_tail=stdout[-3000:],
                 stderr_tail=stderr[-3000:], card=card)
            raise AssertionError(f"scripts: exit {proc.returncode}, {len(runs)} of {len(plan)} runs, "
                                 f"imported {imported}: {stderr[-2000:]}")
        out, launches, lines_of = {}, {}, {}
        for module, argv, lines, counts in runs:
            name = module.rsplit(".", 1)[1]
            key = name if name != "make_reference" else f"make_reference_{argv[1]}spp"
            launches[key], lines_of[key] = counts, lines
            if counts.get("cull", 0) <= 0 or counts.get("closest", 0) + counts.get("closest_hier", 0) <= 0:
                raise AssertionError(f"scripts: {key} launched {counts}")
            out[key] = dict(stdout_tail=lines[-3:])
        if group == "measured":
            _check_measured_scripts(out, lines_of, j)
        elif group == "references":
            _check_reference_scripts(out, lines_of, j, box_downsample)
        else:
            _check_examples(out, lines_of, j, read_rgb8)
        emit("scripts", wall_s=wall, group=group, runs=out, launches=launches, imported=imported, card=card)
        return launches

    return finish


def _check_measured_scripts(out, lines_of, j):
    """`scripts_phase`'s checks of fps_harness and interactive_session."""
    # fps_harness: the reference's two files
    with open(j("fps", "fps_frames.tsv")) as f:
        frames = [ln.rstrip("\n").split("\t") for ln in f]
    with open(j("fps", "fps_summary.tsv")) as f:
        summary = [ln.rstrip("\n").split("\t") for ln in f]
    fov = [r for r in frames[1:] if r[1] == "fov"]
    uni = [r for r in frames[1:] if r[1] == "uni"]
    fov_rays, uni_rays = [float(r[7]) for r in fov], [float(r[7]) for r in uni]
    fov_fps = [1.0 / float(r[3]) for r in fov]
    uni_fps = [1.0 / float(r[3]) for r in uni]
    out["fps_harness"].update(
        fov_fps_mean=float(np.mean(fov_fps)), uni_fps_mean=float(np.mean(uni_fps)),
        fov_over_uni=float(np.mean(fov_fps) / np.mean(uni_fps)), fov_fps=fov_fps, uni_fps=uni_fps,
        fov_rays=fov_rays, uni_rays=uni_rays, width=1200, height=800)
    if (frames[0] != ["i", "mode", "state_s", "render_s", "display_s", "cursorX", "cursorY", "rays"]
            or len(fov) != FPS_FRAMES or len(uni) != FPS_UNI_FRAMES
            or summary[0] != ["city_fov", "city_uni"] or len(summary) != 1 + FPS_FRAMES
            or min(fov_rays + uni_rays) <= 0 or max(fov_rays) >= min(uni_rays)):
        raise AssertionError(f"scripts: fps_harness files {frames[:2]}, {summary[:2]}, "
                             f"rays {fov_rays} / {uni_rays}")

    # interactive_session: the committed session's columns, one row a frame
    with open(j("session.tsv")) as f:
        session = [ln.rstrip("\n").split("\t") for ln in f]
    with open(os.path.join(REPO, "docs", "sessions", "interactive_640x480.tsv")) as f:
        header = f.readline().rstrip("\n").split("\t")
    rec = next(json.loads(ln) for ln in lines_of["interactive_session"] if ln.startswith('{"metric"'))
    out["interactive_session"].update(fps=rec["value"], render_ms_mean=rec["render_ms_mean"],
                                      display_ms_mean=rec["display_ms_mean"])
    if session[0] != header or len(session) != 1 + SESSION_FRAMES or min(float(r[6]) for r in session[1:]) <= 0:
        raise AssertionError(f"scripts: interactive_session rows {session[:2]} ({len(session)})")


def _check_reference_scripts(out, lines_of, j, box_downsample):
    """`scripts_phase`'s checks of make_reference and make_reference_4k."""
    # make_reference: RMSE against the committed reference falls with spp
    ref = os.path.join(REPO, "scenes", "ref_city_600x400.npz")
    rmse = {}
    for n in REF_SPP:
        d = np.load(j(f"ref{n}", "ref_city_600x400.npz"))
        rmse[n], keys = _npz_rmse(d["image"], ref)
        key = f"make_reference_{n}spp"
        out[key].update(rmse_vs_committed=rmse[n], spp=int(d["spp"]),
                        s_per_spp=_seconds_per_spp(lines_of[key], "rendered"))
        if set(d.files) != keys or int(d["spp"]) != n:
            raise AssertionError(f"scripts: {key} keys {d.files} (want {sorted(keys)}), spp {d['spp']}")
    if not rmse[REF_SPP[1]] < rmse[REF_SPP[0]]:
        raise AssertionError(f"scripts: make_reference RMSE {rmse} does not fall with spp")

    # make_reference_4k: the disc against the committed one
    d = np.load(j("ref4k", "ref_city_4k_fovea.npz"))
    want = np.load(os.path.join(REPO, "scenes", "ref_city_4k_fovea.npz"))
    disc_rmse, keys = _npz_rmse(d["image"], os.path.join(REPO, "scenes", "ref_city_4k_fovea.npz"))
    # the 4x4 box downsample on a small array, against loops
    small = np.arange(8 * 12 * 3, dtype=np.float64).reshape(8, 12, 3) ** 1.5
    loops = np.array([[[small[4 * y:4 * y + 4, 4 * x:4 * x + 4, c].mean() for c in range(3)]
                       for x in range(3)] for y in range(2)])
    out["make_reference_4k"].update(disc_rmse_vs_committed=disc_rmse, disc_pixels=int(len(d["idx"])),
                                    s_per_spp=_seconds_per_spp(lines_of["make_reference_4k"], "disc:"),
                                    downsample_max_err=float(np.abs(box_downsample(small) - loops).max()))
    # equal idx: disc_pixels' selection and 16x8 tile order as the committed disc's
    if (set(d.files) != keys or not np.array_equal(d["idx"], want["idx"])
            or not np.allclose(box_downsample(small), loops, rtol=1e-12, atol=0)
            or not np.isfinite(disc_rmse)):
        raise AssertionError(f"scripts: make_reference_4k keys {d.files}, idx equal "
                             f"{np.array_equal(d['idx'], want['idx'])}, RMSE {disc_rmse}")


def _check_examples(out, lines_of, j, read_rgb8):
    """`scripts_phase`'s checks of the examples: a PNG of its size, not
    black, read without PIL."""
    for name, shape in EXAMPLE_SHAPES.items():
        pngs = [j(f"{name}.png")] + ([j(f"{name}_denoised.png")] if name == "render_loft" else [])
        for png in pngs:
            img = read_rgb8(png)
            out[name].setdefault("png", []).append(dict(shape=list(img.shape), mean=float(img.mean())))
            if img.shape != (*shape, 3) or not img.mean() > 1.0:
                raise AssertionError(f"scripts: {png} {img.shape}, mean {img.mean()}")
    res = next(ln for ln in lines_of["demand_textures_demo"] if ln.startswith("resident "))
    resident, total = (int(x) for x in res.split()[1:4:2])
    out["demand_textures_demo"].update(resident_pages=resident, total_pages=total)
    if not 0 < resident < total:
        raise AssertionError(f"scripts: demand demo {res}")


# ---- the traversal backends without a kernel, and the native builders -----

GOLDEN_NAMES = ("disney_open_s", "disney_open", "disney_cornell_s", "disney_cornell", "loft_s",
                "loft", "gltf", "foveated_s", "foveated", "hello", "whitted_s", "whitted",
                "spectral_s", "spectral")
LOCKSTEP_GOLDEN_TOL = 1e-5  # sqrt-space RMSE, the card's lockstep render against the CPU's
# ... or, where the card's shading already parts from the CPU's on the
# cluster walk, the lockstep render parts by that much and no more
WALK_ADDS_TOL = 1e-6
# ROADMAP C.9: the setups whose card render parts from the CPU's by more than
# LOCKSTEP_GOLDEN_TOL after the repairs (the probe tables built on the host,
# the spectral band's divisor a device scalar, the hero sums in the CPU's
# order, one writer per pixel in the foveated splat). What remains is the
# CUDA math library's ulps against ATen's CPU kernels on identical inputs
# (`experiments/device_parity.py`: rsqrt, sqrt, sin, cos, atan2, acos, exp,
# pow, sigmoid), pinned by tests/test_torch_cuda_kernels.py's C.9 cases.
# Each limit is 1.5x the gap measured on the card (sqrt-space RMSE, the
# larger of the two walks), every other setup is held to LOCKSTEP_GOLDEN_TOL.
C9_PINNED = {  # name -> limit; the gap measured on one H100 (both walks alike)
    "whitted": 4.7e-4,  # 3.119e-4
    "disney_open": 9.8e-5,  # 6.515e-5
    "spectral": 6.3e-5,  # 4.185e-5
}
PR13_BIG_NUMPY_BUILD_S = (33.29, 41.13)  # big_scene build_s, PR 13's runs W1 / F1 (numpy builders)
GATE_RAYS = 8192  # bench.py's gate rays (`mixed_rays`)
TIE_REL = 1e-5  # lockstep t against the oracle's: a few ulps (their arithmetic differs)


def cpu_lockstep_golden(name):
    """One golden's CPU renders through the lockstep and the cluster walk,
    in a worker process of `start_cpu_goldens` (one torch thread):
    {walk: (image, seconds)}."""
    import torch

    from optixpathtracer_tpu_torch import scenes

    torch.set_num_threads(1)
    out = {}
    for walk_name in ("lockstep", "cluster"):
        t0 = time.perf_counter()
        img = scenes.render_golden(name, torch.device("cpu"), walk_name)
        out[walk_name] = (img, time.perf_counter() - t0)
    return out


def start_cpu_goldens(workers=3):
    """The 14 goldens' CPU lockstep renders, started in worker processes so
    that they run beside the card's phases; `lockstep_goldens` collects
    them. Returns (executor, {name: future})."""
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(cpu_lockstep_golden, name) for name in GOLDEN_NAMES}


@contextlib.contextmanager
def numpy_builders():
    """OPTIX_TPU_NO_NATIVE=1 within the block: the numpy builders."""
    old = os.environ.get("OPTIX_TPU_NO_NATIVE")
    os.environ["OPTIX_TPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["OPTIX_TPU_NO_NATIVE"]
        else:
            os.environ["OPTIX_TPU_NO_NATIVE"] = old


def _host_timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _median_cluster_radius(ctr, order, c):
    """Median bounding radius of the aligned c-runs of `order` (the treelet
    order's contract, bvh/clusters.py `treelet_order`)."""
    n = len(order) // c * c
    grouped = ctr[order[:n]].reshape(-1, c, 3)
    half = (grouped.max(axis=1) - grouped.min(axis=1)) / 2
    return float(np.median(np.sqrt((half * half).sum(axis=1))))


def native_build(hs, card):
    """On the city (leaf 8, cluster 256, as the bench builds it): the native
    `build_binary`, `wide_collapse` and `cluster_tables` bit-equal to the
    numpy builders (OPTIX_TPU_NO_NATIVE=1), the host seconds of each path,
    and the median cluster radius of the native and the numpy
    `treelet_order` (their contract)."""
    from optixpathtracer_tpu_torch.bvh import clusters, lbvh, native, wide
    from optixpathtracer_tpu_torch.utils import host_build

    if native.get_lib() is None or "accel" not in host_build._libs:
        raise AssertionError("native_build: the native library did not load")
    v0, v1, v2 = hs.flatten()["v"]
    c, k = 256, 8
    secs = {}
    nat, secs["build_binary_native"] = _host_timed(lambda: lbvh.build_bvh(v0, v1, v2, leaf_size=k))
    with numpy_builders():
        ref, secs["build_binary_numpy"] = _host_timed(lambda: lbvh.build_bvh(v0, v1, v2, leaf_size=k))
    if nat.depth != ref.depth or not np.array_equal(nat.order, ref.order) or not all(
            np.array_equal(nat.host[f], ref.host[f]) for f in ref.host):
        raise AssertionError("native_build: build_binary differs from the numpy build")
    h = nat.host
    args = (h["left"], h["right"], h["lmin"], h["lmax"], h["rmin"], h["rmax"], nat.padded_count // k, 8)
    wn, secs["wide_collapse_native"] = _host_timed(lambda: native.wide_collapse(*args))
    wr, secs["wide_collapse_numpy"] = _host_timed(lambda: wide.collapse(*args))
    if wn[2] != wr[2] or not (np.array_equal(wn[0], wr[0]) and np.array_equal(wn[1], wr[1])):
        raise AssertionError("native_build: wide_collapse differs from the numpy collapse")
    ctr = ((v0.astype(np.float64) + v1 + v2) / 3.0)[nat.order]
    tn, secs["treelet_order_native"] = _host_timed(lambda: clusters.treelet_order(ctr, c))
    with numpy_builders():
        tr, secs["treelet_order_numpy"] = _host_timed(lambda: clusters.treelet_order(ctr, c))
    if sorted(tn.tolist()) != list(range(len(ctr))):
        raise AssertionError("native_build: the native treelet order is not a permutation")
    sv = [v[nat.order[tn]] for v in (v0, v1, v2)]
    tbn, secs["cluster_tables_native"] = _host_timed(
        lambda: native.cluster_tables(*sv, nat.padded_count, c))
    tbr, secs["cluster_tables_numpy"] = _host_timed(
        lambda: clusters._cluster_tables_np(*sv, nat.padded_count, c))
    if not all(np.array_equal(tbn[f], tbr[f]) for f in tbr):
        raise AssertionError("native_build: cluster_tables differ from the numpy tables")
    radius = dict(native=_median_cluster_radius(ctr, tn, c), numpy=_median_cluster_radius(ctr, tr, c))
    emit("native_build", triangles=len(v0), leaf_size=k, cluster_size=c, bit_equal=True,
         host_seconds=secs, gxx_seconds=dict(host_build.build_seconds),
         median_cluster_radius=radius, card=card)
    if radius["native"] > 1.10 * radius["numpy"]:
        raise AssertionError(f"native_build: native clusters looser than numpy's: {radius}")


def _ties(rec, want, rel=0.0):
    """(rays whose triangles are apart, of them those at a tie, rays whose
    t is apart): a tie is the same t, to `rel` relative where the two
    walks round their Möller–Trumbore arithmetic differently (the lockstep
    walk against the clusters' pre-differenced rows)."""
    close = (rec.t - want.t).abs() <= rel * want.t.abs()
    apart = rec.tri != want.tri
    hit = want.tri >= 0  # a miss keeps t_max on one walk, BIG_T on another
    return int(apart.sum()), int((apart & close).sum()), int((hit & ~close).sum())


def _records_equal(a, b) -> bool:
    return all(bool((getattr(a, f).cpu() == getattr(b, f).cpu()).all()) for f in ("t", "tri", "u", "v"))


def _one_frame(renderer, warm=None):
    """(seconds, rays) of one `render(download=False)`, after `warm`'s
    frame (a renderer of 1/16 the pixels) where given."""
    import torch

    if warm is not None:
        warm.render(download=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    renderer.render(download=False)
    return time.perf_counter() - t0, int(renderer.last_output.rays_traced)


def backend_slices(hs, dev, card):
    """bench.py's CPU headline on the card (`lockstep_city`): `disney_pt` on
    the city at 1200x800, 2 spp, depth 4, `compile_scene(leaf_size=8,
    build_wide_bvh=False, cluster_size=256)`, `batch_spp`,
    `nee_final_bounce=False`, no sort, through the lockstep walk: one timed
    frame after a 1/16-frame warm-up, walk iterations per sweep, the frame
    against the cluster walk's (sqrt RMSE); one sweep of the frame's primary
    rays with the loop condition read every CHECK_EVERY iterations and every
    iteration, in turns (the same records, both timed); on the 8192 gate
    rays the lockstep `tri` against `reference_closest`'s (apart only at
    ties, t within TIE_REL) and the card bit-equal to the CPU. `bfs_city`:
    the same with the wide BVH and `traversal="bfs"` (cap 4), its overflow;
    on the gate rays
    at cap 8 the overflow and the rays apart from lockstep's (the worklist
    truncates there, as the reference's does), the card bit-equal to the
    CPU."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
    from optixpathtracer_tpu_torch.ops import traverse, traverse_bfs
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    cpu = torch.device("cpu")
    flags = dict(batch_spp=True, nee_final_bounce=False)
    cam = scenes.city_camera(WIDTH, HEIGHT)
    probe = scenes.city_sky(dev)

    def renderers(cs, traversal):
        small = make_disney_pt_renderer(cs, probe, scenes.city_camera(WIDTH // 4, HEIGHT // 4),
                                        width=WIDTH // 4, height=HEIGHT // 4, spp=SPP, max_depth=DEPTH,
                                        traversal=traversal, **flags)
        full = make_disney_pt_renderer(cs, probe, cam, width=WIDTH, height=HEIGHT, spp=SPP,
                                       max_depth=DEPTH, traversal=traversal, **flags)
        return small, full

    cs, build_s = _host_timed(lambda: compile_scene(hs, dev, leaf_size=8, build_wide_bvh=False,
                                                    cluster_size=256))
    small, r = renderers(cs, "lockstep")
    t0 = time.perf_counter()
    small.render(download=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    traverse.walk_stats.update(sweeps=0, iterations=0)
    frame_s, rays = _one_frame(r)
    walk = dict(traverse.walk_stats)
    peak = torch.cuda.max_memory_allocated()
    img_lock = r.accum_image()
    # the loop condition read every CHECK_EVERY iterations against every
    # one, on the frame's primary rays, once each: the same records
    from optixpathtracer_tpu_torch.engine import wavefront

    o1, d1 = wavefront.first_bounce_rays(r.config, wavefront.CameraParams.from_camera(cam, dev), *r.pixels)
    sync = {}
    every = traverse.CHECK_EVERY
    try:
        for k in (every, 1):
            traverse.CHECK_EVERY = k
            ms, rec = timed(lambda: traverse.closest_hit(cs.bvh, cs.scene, o1, d1, 1e-3, 1e16))
            sync.setdefault(k, []).append(ms)
            if k == 1:
                rec_1 = rec
            else:
                rec_k = rec
    finally:
        traverse.CHECK_EVERY = every
    sync_equal = _records_equal(rec_1, rec_k)
    n_primary = o1.x.shape[0]
    del small, r, o1, d1, rec, rec_1, rec_k
    _, rc = renderers(cs, "cluster")
    cluster_s, cluster_rays = _one_frame(rc)
    rmse = scenes.golden_rmse(img_lock, rc.accum_image())
    del rc
    og, dg = mixed_rays(cs, hs, cam, GATE_RAYS, 42, dev)
    lock = traverse.closest_hit(cs.bvh, cs.scene, og, dg, 1e-3, 1e16)
    exact = tc.reference_closest(cs.clusters, og, dg, 1e-3, 1e16)
    apart, ties, t_apart = _ties(lock, exact, rel=TIE_REL)
    ccs = compile_scene(hs, cpu, leaf_size=8, build_wide_bvh=False, build_cluster_set=False,
                        cluster_size=256)
    lock_cpu = traverse.closest_hit(ccs.bvh, ccs.scene, *(type(v)(*(c.cpu() for c in v)) for v in (og, dg)),
                                    1e-3, 1e16)
    card_eq_cpu = _records_equal(lock, lock_cpu)
    emit("lockstep_city", width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH, flags=flags,
         build_s=build_s, warm_up_s=warm_s, warm_up_size=[WIDTH // 4, HEIGHT // 4], frame_s=frame_s,
         rays_traced=rays, mrays_per_s=rays / frame_s / 1e6, sweeps=walk["sweeps"],
         iterations_per_sweep=walk["iterations"] / max(1, walk["sweeps"]),
         check_every=traverse.CHECK_EVERY, max_memory_allocated=peak,
         primary_sweep_ms_by_check_every={str(k): v for k, v in sync.items()},
         primary_rays=n_primary, check_every_records_equal=sync_equal,
         cluster_frame_s=cluster_s, cluster_rays=cluster_rays, rmse_vs_cluster=rmse,
         gate=dict(rays=GATE_RAYS, apart_from_oracle=apart, at_ties=ties, t_apart=t_apart, tie_rel=TIE_REL,
                   hits=int((exact.tri >= 0).sum()), card_bit_equal_cpu=card_eq_cpu), card=card)
    if apart != ties or t_apart or not card_eq_cpu or rays != cluster_rays or rmse > RMSE_TOL \
            or not sync_equal:
        raise AssertionError(f"lockstep_city: {apart} apart from the oracle ({ties} at ties), {t_apart} t "
                             f"mismatches, card == CPU {card_eq_cpu}, rays {rays} / {cluster_rays}, "
                             f"RMSE against the cluster walk {rmse}")
    del cs, ccs, exact, lock_cpu
    torch.cuda.empty_cache()

    csw, build_s = _host_timed(lambda: compile_scene(hs, dev, leaf_size=8, build_wide_bvh=True,
                                                     cluster_size=256))
    small, r = renderers(csw, "bfs")
    frame_s, rays = _one_frame(r, warm=small)
    peak = torch.cuda.max_memory_allocated()
    overflow = float(r.last_output.bfs_overflow)
    cap = r.config.bfs_cap_factor
    img_bfs = r.accum_image()
    del small, r
    torch.cuda.empty_cache()
    res = traverse_bfs.closest_hit_bfs(csw.wide, og, dg, 1e-3, 1e16, cap_factor=8)
    apart, ties, t_apart = _ties(res.record, lock)
    ccs = compile_scene(hs, cpu, leaf_size=8, build_wide_bvh=True, build_cluster_set=False, cluster_size=256)
    res_cpu = traverse_bfs.closest_hit_bfs(ccs.wide, *(type(v)(*(c.cpu() for c in v)) for v in (og, dg)),
                                           1e-3, 1e16, cap_factor=8)
    card_eq_cpu = _records_equal(res.record, res_cpu.record) and float(res.overflow) == float(res_cpu.overflow)
    emit("bfs_city", width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH, flags=flags, build_s=build_s,
         wide_nodes=csw.wide.num_nodes, wide_depth=csw.wide.depth, cap_factor=cap, frame_s=frame_s,
         rays_traced=rays, mrays_per_s=rays / frame_s / 1e6, bfs_overflow=overflow,
         max_memory_allocated=peak, rmse_vs_lockstep=scenes.golden_rmse(img_bfs, img_lock),
         gate=dict(rays=GATE_RAYS, cap_factor=8, overflow=float(res.overflow), apart_from_lockstep=apart,
                   at_exact_t_ties=ties, t_mismatches=t_apart, card_bit_equal_cpu=card_eq_cpu), card=card)
    # the worklist truncates on the city's gate rays at cap 8 (so does the
    # reference's, to the same count: tests/test_torch_traverse_bfs.py), so
    # what is held is the card against the CPU, bit for bit, overflow
    # included; the exact-t ties apart from lockstep are printed (the BFS
    # keeps the last pair of a tie, lockstep the first)
    if not card_eq_cpu or not np.isfinite(img_bfs).all():
        raise AssertionError("bfs_city: the card differs from the CPU on the gate rays")
    del csw, ccs, res, res_cpu, og, dg, lock
    torch.cuda.empty_cache()


def backend_loft(dev, card):
    """`dense_loft` and `oracle_loft`: bench.py's loft row (`loft_slice`'s
    configuration, 1200x800, 2 spp, depth 4, `scenes.loft_config`) through
    the dense scan and the oracle, a timed frame after a warm-up each,
    against the cluster walk's (sqrt RMSE), the dense scan's peak device memory (rays in chunks of
    DENSE_CHUNK_ELEMS // BLOCK), and on 8192 gate rays the card against
    the CPU, bit for bit, and the triangles apart from the oracle's (the
    dense scan keeps the lowest sorted index of a tie, the oracle the
    cluster order's first), all at ties."""
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.io.obj import load_obj
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
    from optixpathtracer_tpu_torch.ops import dense, dispatch

    cpu = torch.device("cpu")
    hs = load_obj(scenes.LOFT_OBJ)
    cs = compile_scene(hs, dev, leaf_size=8, cluster_size=256)
    ccs = compile_scene(hs, cpu, leaf_size=8, cluster_size=256)
    setup = scenes.loft_config(WIDTH, HEIGHT, dev)
    imgs = {}
    og, dg = mixed_rays(cs, hs, setup.camera, GATE_RAYS, 42, dev)
    ogc, dgc = (type(v)(*(c.cpu() for c in v)) for v in (og, dg))
    for tr in ("cluster", "dense", "oracle"):
        r = make_disney_pt_renderer(cs, setup.probe, setup.camera, width=WIDTH, height=HEIGHT, spp=SPP,
                                    max_depth=DEPTH, traversal=tr, **setup.flags)
        r.render(download=False)  # warm-up: the compared images accumulate two frames
        frame_s, rays = _one_frame(r)
        peak = torch.cuda.max_memory_allocated()
        imgs[tr] = r.accum_image()
        del r
        if tr == "cluster":
            continue
        card_rec = dispatch.trace_closest(cs, og, dg, 1e-3, 1e16, traversal=tr)
        cpu_rec = dispatch.trace_closest(ccs, ogc, dgc, 1e-3, 1e16, traversal=tr)
        apart, ties, t_apart = _ties(card_rec, dispatch.trace_closest(cs, og, dg, 1e-3, 1e16,
                                                                      traversal="oracle"), rel=TIE_REL)
        rmse = scenes.golden_rmse(imgs[tr], imgs["cluster"])
        eq = _records_equal(card_rec, cpu_rec)
        emit(f"{tr}_loft", width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH, flags=setup.flags,
             triangles=cs.num_triangles, frame_s=frame_s, rays_traced=rays, mrays_per_s=rays / frame_s / 1e6,
             max_memory_allocated=peak, rmse_vs_cluster=rmse,
             **({"chunk_rays": dense.DENSE_CHUNK_ELEMS // dense.BLOCK} if tr == "dense" else {}),
             gate=dict(rays=GATE_RAYS, card_bit_equal_cpu=eq, hits=int((cpu_rec.tri >= 0).sum()),
                       apart_from_oracle=apart, at_ties=ties, t_apart=t_apart, tie_rel=TIE_REL), card=card)
        if not (eq and rmse <= RMSE_TOL and apart == ties and not t_apart):
            raise AssertionError(f"{tr}_loft: card == CPU {eq}, RMSE against the cluster walk {rmse}, "
                                 f"{apart} apart from the oracle ({ties} at ties), {t_apart} t apart")
    del cs, ccs
    torch.cuda.empty_cache()


def lockstep_goldens(dev, futures, card):
    """All 14 goldens through the lockstep walk on the card, each against
    the port's CPU render of the same setup and walk, and reported against
    its golden. The card's lockstep render is held to the CPU's within
    LOCKSTEP_GOLDEN_TOL, or, where the card's shading already parts from
    the CPU's through the cluster walk (the same setup rendered by both on
    both devices), to that departure within WALK_ADDS_TOL: the walk adds
    nothing of its own."""
    from optixpathtracer_tpu_torch import scenes

    out = {}
    for name in GOLDEN_NAMES:
        cpu = futures[name].result(timeout=600)
        want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
        row = {}
        for walk_name in ("lockstep", "cluster"):
            t0 = time.perf_counter()
            got = scenes.render_golden(name, dev, walk_name)
            row[walk_name] = dict(rmse_vs_cpu=scenes.golden_rmse(got, cpu[walk_name][0]),
                                  rmse_vs_golden=scenes.golden_rmse(got, want),
                                  card_s=time.perf_counter() - t0, cpu_s=cpu[walk_name][1])
            if walk_name == "lockstep":
                lock_img = got
        row["lockstep_vs_cluster_card"] = scenes.golden_rmse(lock_img, got)
        out[name] = row
    emit("lockstep_goldens", goldens=out, tol_vs_cpu=LOCKSTEP_GOLDEN_TOL, walk_adds_tol=WALK_ADDS_TOL,
         card=card)
    bad = {k: v for k, v in out.items()
           if not (v["lockstep"]["rmse_vs_cpu"] <= LOCKSTEP_GOLDEN_TOL
                   or abs(v["lockstep"]["rmse_vs_cpu"] - v["cluster"]["rmse_vs_cpu"]) <= WALK_ADDS_TOL)}
    if bad:
        raise AssertionError(f"lockstep_goldens: the card's lockstep walk parts from the CPU's: {bad}")
    # C.9: every setup card against CPU on both walks, at 1e-5 or its pinned limit
    apart = {k: (max(v[w]["rmse_vs_cpu"] for w in ("lockstep", "cluster")), C9_PINNED.get(k, LOCKSTEP_GOLDEN_TOL))
             for k, v in out.items()}
    emit("c9_card_vs_cpu", gaps={k: g for k, (g, _) in apart.items()},
         limits={k: lim for k, (_, lim) in apart.items()}, card=card)
    over = {k: gl for k, gl in apart.items() if not gl[0] <= gl[1]}
    if over:
        raise AssertionError(f"lockstep_goldens: card against CPU above the C.9 limits: {over}")


def backend_phases(hs, dev, card, cpu_goldens=None):
    """The phases of the backends without a kernel and the native builders,
    in order: native_build, lockstep_city, bfs_city, dense_loft,
    oracle_loft, and with cpu_goldens lockstep_goldens. Returns their
    seconds."""
    t0 = time.perf_counter()
    native_build(hs, card)
    backend_slices(hs, dev, card)
    backend_loft(dev, card)
    if cpu_goldens is not None:
        lockstep_goldens(dev, cpu_goldens, card)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="chip smoke test of the port on one NVIDIA GPU")
    parser.add_argument("--only", choices=["backends", "bench", "scripts", "codecs"], default=None,
                        help="backends: the build, the city and the phases of the backends "
                             "without a kernel and the native builders, then exit; bench: "
                             "the build and the bench's phases (bench_small, bench_hostile); "
                             "scripts: the build and the `scripts` phase")
    args = parser.parse_args(argv)

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

    from optixpathtracer_tpu_torch.ops import cuda_build
    from optixpathtracer_tpu_torch.utils import host_build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip() if smi else 'unknown'}"
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build: one nvcc per source and one g++ per host library, all
    # started together ------------------------------------------------------
    t0 = time.perf_counter()
    names = sorted({os.path.splitext(os.path.basename(src))[0] for src in SOURCES.values()})
    # csrc/host: the native builders, the OBJ tokenizer, JPEG 2000's tier 1,
    # AVIF's AV1 tile decoder
    host_libs = ("accel", "objparser", "j2k_t1", "av1_dec")
    with concurrent.futures.ThreadPoolExecutor(len(names) + len(host_libs)) as pool:
        list(pool.map(lambda f: f[0](f[1]), [(cuda_build.load, n) for n in names]
                      + [(host_build.load, n) for n in host_libs]))
    builds = {}
    for name in names:
        info = cuda_build.build_info[name]
        builds[name] = dict(nvcc_seconds=info["seconds"], ptxas=[
            ln.strip() for ln in info["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln])
    emit("build", seconds=time.perf_counter() - t0, sources=builds,
         host_libraries={n: dict(gxx_seconds=host_build.build_seconds[n]) for n in host_libs})
    if args.only in ("bench", "scripts", "codecs"):  # no golden is rendered
        try:
            return _phases(args, dev, card, smi, None)
        finally:
            _stop_children()
    # the goldens' CPU lockstep renders run beside the card's phases
    cpu_pool, cpu_goldens = start_cpu_goldens()
    try:
        return _phases(args, dev, card, smi, cpu_goldens)
    finally:
        _stop_children()
        cpu_pool.shutdown(wait=True, cancel_futures=True)


def _phases(args, dev, card, smi, cpu_goldens) -> int:
    import torch

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.engine.foveated import FoveationConfig
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer, make_foveated_renderer
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc


    if args.only == "codecs":
        t1 = time.perf_counter()
        launches, launches2, launches3, launches_avif, launches_avif3 = codecs_scene(dev, card, tc.launch_counts)
        emit("codecs_phase", seconds=time.perf_counter() - t1, launches=launches, launches_lossless2=launches2,
             launches_lossless3=launches3, launches_lossy2=launches_avif, launches_lossy3=launches_avif3,
             card=card)
        print(smi, flush=True)
        return 0

    # ---- the city, and the slice's renderer ------------------------------
    t0 = time.perf_counter()
    hs = scenes.build_city_scene()
    if args.only == "backends":
        emit("backend_phases", seconds=backend_phases(hs, dev, card, cpu_goldens), card=card)
        print(smi, flush=True)
        return 0
    if args.only == "bench":
        t1 = time.perf_counter()
        runs = {"bench_small": bench_small(card), "bench_hostile": bench_hostile(dev, card)}
        emit("bench_phases", seconds=time.perf_counter() - t1, launches=runs, card=card)
        print(smi, flush=True)
        return 0
    if args.only == "scripts":
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            runs = scripts_phase(card, tmp, "measured")()
            finishes = [scripts_phase(card, tmp, group) for group in ("references", "examples")]
            for finish in finishes:
                runs.update(finish())
        emit("scripts_phase", seconds=time.perf_counter() - t1, launches=runs, card=card)
        print(smi, flush=True)
        return 0
    cs = compile_scene(hs, dev, **CITY_BUILD)
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
                             SIDE_PLAIN_BUDGET_S, wf2, card)
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
                                  peak, SIDE_PLAIN_BUDGET_S, wf2, card)
    second_hier = time_hier(cl, tc.block_cull_nodes(cl, o2, d2, tm2, tM2),
                            tc.block_cull_nodes(cl, p2, wi2, tms2, tMs2), peak, wf2, card,
                            budget_s=SIDE_PLAIN_BUDGET_S)
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

    gate_phase("exactness_gate", cs, hs, cam, dev)
    route_ties(cl, o1, d1, cfg, dev, card)  # C.7: the walks' exact-t ties, counted

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
    # ---- strip and lane sharding over torch.distributed, on this card -----
    dist_runs, dist_per_rank = dist_phases(cs, probe, dev, card)
    torch.cuda.empty_cache()
    # ---- the port's bench in child processes: --small, then the hostile
    # scene at full size with its executed-pair counts held in this process
    bench_runs = {"bench_small": bench_small(card), "bench_hostile": bench_hostile(dev, card)}
    torch.cuda.empty_cache()
    # ---- the scripts beside the package (tools/, examples/) as the port's
    # modules, in a child process
    with tempfile.TemporaryDirectory() as tmp:
        script_runs = scripts_phase(card, tmp, "measured")()
    del renderer, o, d, cr, cr_s
    torch.cuda.empty_cache()
    # ---- the engine's last options: fused shadows on the city, env_via_bsdf
    # and nee_rr on the open scene
    fused_launches = engine_options(cs, probe, dev, card, tc.launch_counts)
    torch.cuda.empty_cache()
    # ---- the backends without a kernel (lockstep, BFS, dense, oracle) and
    # the native builders; the lockstep goldens run beside the CLI's children
    emit("backend_phases", seconds=backend_phases(hs, dev, card), card=card)
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
    torch.cuda.empty_cache()

    # ---- the other presets: hello and spectral on the city, whitted on its
    # own scene, their goldens ----------------------------------------------
    hello_launches, hello_t, preset_errs = hello_slice(cs, dev, peak, card, tc.launch_counts)
    spectral_launches, spectral_t, spectral_errs = spectral_slice(cs, probe, peak, card, tc.launch_counts)
    torch.cuda.empty_cache()
    whitted_launches, whitted_t, whitted_errs = whitted_slice(dev, peak, card, tc.launch_counts)
    for name, e in (*preset_errs.items(), *whitted_errs.items(), *spectral_errs.items()):
        errs[name] = max(errs[name], e)
    preset_goldens(dev, card)
    # ---- the viewer on the city: disney_pt 1200x800 and foveated 4K fused --
    view_launches = view_slice(cs, probe, dev, card, tc.launch_counts)
    del cs, cl, hs
    foveated_checks(dev)  # the goldens, and fused == three launches
    torch.cuda.empty_cache()

    # ---- scenes from files and the area light: the flat walk's main paths
    loft_launches, loft_t, loft = loft_slice(dev, peak, card, tc.launch_counts)
    for name in WALK_KERNELS["flat"]:
        errs[name] = max(errs[name], *(t[name]["max_abs_err"] for t in loft_t.values()))
    # ---- demand-loaded textures: the loft row, then a 4096^2 texture --------
    demand_loft_launches = demand_loft(*loft, dev, card, tc.launch_counts)
    del loft
    demand_big_launches, demand_big_t = demand_big(dev, peak, card, tc.launch_counts)
    for name in WALK_KERNELS["flat"]:
        errs[name] = max(errs[name], *(t[name]["max_abs_err"] for t in demand_big_t.values()))
    torch.cuda.empty_cache()
    cornell_launches = cornell_slice(dev, card, tc.launch_counts)
    file_goldens(dev)
    jpeg_launches = jpeg_scene(dev, card, tc.launch_counts)
    codecs_launches, codecs2_launches, codecs3_launches, codecs_avif_launches, codecs_avif3_launches = codecs_scene(
        dev, card, tc.launch_counts)
    torch.cuda.empty_cache()

    # ---- the instanced city (TLAS) through the CLI's renderer, and the CLI
    with tempfile.TemporaryDirectory() as tmp:
        inst_runs, inst_t, inst_errs, glb = instanced_phases(tmp, dev, peak, card, tc.launch_counts)
        for name, e in inst_errs.items():
            errs[name] = max(errs[name], e)
        torch.cuda.empty_cache()
        # the other scripts and the CLI's seven children, started together,
        # and the lockstep goldens beside them: checks whose times nothing
        # holds to a limit
        scripts = [scripts_phase(card, tmp, group) for group in ("references", "examples")]
        cli = [cli_render(glb, tmp, card), cli_presets(tmp, card), cli_demand_view(tmp, card)]
        lockstep_goldens(dev, cpu_goldens, card)
        for finish in scripts:
            script_runs.update(finish())
        for finish in cli:
            finish()

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
    cs = compile_scene(hs, dev, **CITY_BUILD)
    cl = cs.clusters
    nt = cl.node_tables
    torch.cuda.synchronize()
    emit("big_scene", triangles=cs.num_triangles, entries=cl.num_entries,
         nodes=nt.csph.shape[0], cluster_size=cl.cluster_size, scene_host_s=host_s,
         build_s=time.perf_counter() - t0, builders="native",
         pr13_numpy_build_s=PR13_BIG_NUMPY_BUILD_S,
         routes_to_node_walk=cl.num_entries >= tc.HIER_MIN_ENTRIES)
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
        plain_ms, nr, err = check_vs_plain(name, kern, plain, nr_mixed, SIDE_PLAIN_BUDGET_S)
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
    big_t["cull"] = cull_phase("cull (node table)", rays8_1, *node_tables, peak, SIDE_PLAIN_BUDGET_S, wf, card)
    block_cull_parts("block_cull_nodes", tc.block_cull_nodes, cl, (o1, d1, cfg.t_min, cfg.t_max),
                     node_tables, wf, card)

    first = time_hier(cl, cr1, cr_sh, peak, wf, card, budget_s=SIDE_PLAIN_BUDGET_S)
    big_t.update(first)
    # the second bounce is the engine's own: the rays `trace_wavefront` hands
    # to its sweeps at depth 1 of a frame of this renderer
    (o2, d2, tm2, tM2), (p2, wi2, tms2, tMs2) = engine_bounce(renderer, 1)
    wf2 = "big scene second bounce (the engine's), 1200x800x2spp"
    second_cull = cull_phase("cull (node table)", tc._pack_rays8(cl, o2, d2, tm2, tM2), *node_tables,
                             peak, SIDE_PLAIN_BUDGET_S, wf2, card)
    errs["cull"] = max(errs["cull"], big_t["cull"]["max_abs_err"], second_cull["max_abs_err"])
    block_cull_parts("block_cull_nodes", tc.block_cull_nodes, cl, (o2, d2, tm2, tM2), node_tables, wf2, card)
    block_cull_parts("block_cull_nodes", tc.block_cull_nodes, cl, (p2, wi2, tms2, tMs2), node_tables,
                     wf2 + ", shadow rays", card)
    # held against the plain versions, without bounds: the counting walks
    # over the big scene's 530 nodes take tens of seconds
    second = time_hier(cl, tc.block_cull_nodes(cl, o2, d2, tm2, tM2),
                       tc.block_cull_nodes(cl, p2, wi2, tms2, tMs2), peak, wf2, card,
                       budget_s=SIDE_PLAIN_BUDGET_S, bound=False)
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
            "cornell": cornell_launches, **inst_runs, "fused_shadows": fused_launches,
            "hello": hello_launches, "whitted": whitted_launches, "spectral": spectral_launches,
            "demand_loft": demand_loft_launches, "demand_big": demand_big_launches, "view": view_launches,
            **dist_runs, **bench_runs, **script_runs, "jpeg_scene": jpeg_launches, "codecs_scene": codecs_launches,
            "codecs_scene_lossless2": codecs2_launches, "codecs_scene_lossless3": codecs3_launches,
            "codecs_scene_lossy2": codecs_avif_launches, "codecs_scene_lossy3": codecs_avif3_launches,
            "big_slice": big_launches}
    for run in runs.values():
        for name, k in run.items():
            launches[name] = launches.get(name, 0) + k
    # each kernel's numbers on the path it serves first: K1, K4a and K4b on
    # the city's main path (the node walk), K2 and K3 on the flat city
    # slice; `paths` gives each path's launches and, where its first bounce
    # was timed, the kernel's ms there
    timed_at = {"slice": city_t, "flat_slice": flat_t, "loft": loft_t["first bounce"],
                "demand_big": demand_big_t["first bounce"], **inst_t,
                "hello": hello_t, "whitted": whitted_t, "spectral": spectral_t, "big_slice": big_t}
    timing.update(flat_t, **city_t)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": KERNELS[name],
         "launches": launches.get(name, 0), "max_abs_err": errs[name],
         **{k: timing[name][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            if k in timing[name]},
         "paths": {path: {"launches": run.get(name, 0),
                          **({"launches_per_rank": [r.get(name, 0) for r in dist_per_rank[path]]}
                             if path in dist_per_rank else {}),
                          **({k: timed_at[path][name][k] for k in ("ms", "rays", "plain_ms", "plain_rays", "bound_ms")
                              if k in timed_at[path][name]} if name in timed_at.get(path, {}) else {})}
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
