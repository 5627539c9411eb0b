"""Run configuration and its command-line flags (port of
optixpathtracer_tpu/utils/config.py).

`RunConfig` is the whole run spec — model preset, scene, camera and render
knobs — as one JSON-serialisable dataclass tree with the reference's
fields, defaults and JSON keys, so a config file written by either package
loads in the other. `add_config_args` / `config_from_args` are its flags: a
JSON `--config` first, then every flag given on top. `--device` (default
"cuda") is the one flag the reference lacks; it is not part of the JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..engine.foveated import FoveationConfig
from ..engine.wavefront import RenderConfig


@dataclasses.dataclass
class CameraSpec:
    eye: tuple = (3.0, 2.0, 4.0)
    lookat: tuple = (0.0, 0.4, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_y: float = 35.0


@dataclasses.dataclass
class RunConfig:
    """Top-level run spec: model preset + scene + camera + render knobs."""

    model: str = "disney_pt"  # hello_raytracing | whitted | disney_pt | spectral | foveated
    scene: str = ""  # .obj / .gltf / .glb path, or "" for the procedural boxes
    probe: str = ""  # .hdr path, or "" for a uniform sky
    probe_level: float = 0.5  # uniform sky radiance when probe == ""
    out: str = "out.png"
    frames: int = 1  # progressive launches
    width: int = 1200
    height: int = 800
    spp: int = 4
    max_depth: int = 4
    traversal: str = "lockstep"  # a CUDA device takes "cluster" without --traversal (cli.pick_traversal)
    emission_all_bounces: bool = False  # emissive geometry lights the scene
    #   through BSDF paths (closed interiors such as scenes/loft.obj)
    nee_final_bounce: bool = True  # False skips the last bounce's NEE sweep
    nee_rr: float = 0.0  # Russian-roulette shadow-ray threshold (0 = always trace)
    russian_roulette: bool = False  # throughput-proportional path termination
    rr_start_depth: int = 2
    sampling: str = "random"  # random | stratified | blue | sobol
    sampling_strata: int = 64  # strata / blue-noise points per pixel epoch
    denoise: bool = False
    tonemap: str = "reinhard"
    exposure: float = 0.0
    checkpoint: str = ""  # resume / save progressive state here
    metrics: str = ""  # JSONL per-frame metrics path
    gaze: tuple = (-1, -1)  # foveated: gaze pixel (defaults to the centre)
    fused_foveation: bool | None = None  # all zones in one launch; None = preset default
    instanced: bool = False  # glTF: keep node reuse as a multi-prototype TLAS
    demand_textures: int = 0  # >0: the demand-loaded texture pool's capacity in tiles
    adaptive: bool = False  # disney_pt: variance-guided adaptive sampling
    adaptive_fraction: float = 0.25  # fraction of tiles refined per round
    camera: CameraSpec = dataclasses.field(default_factory=CameraSpec)
    foveation: FoveationConfig = dataclasses.field(default_factory=FoveationConfig)

    def render_config(self, **overrides) -> RenderConfig:
        return RenderConfig(
            width=self.width,
            height=self.height,
            samples_per_launch=self.spp,
            max_depth=self.max_depth,
            traversal=self.traversal,
            emission_all_bounces=self.emission_all_bounces,
            nee_final_bounce=self.nee_final_bounce,
            nee_rr=self.nee_rr,
            russian_roulette=self.russian_roulette,
            rr_start_depth=self.rr_start_depth,
            sampling=self.sampling,
            sampling_strata=self.sampling_strata,
            **overrides,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        d = json.loads(text)
        cam = CameraSpec(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in d.pop("camera", {}).items()})
        fov = FoveationConfig(**d.pop("foveation", {}))
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return RunConfig(camera=cam, foveation=fov, **d)


# the flags config_from_args copies onto the RunConfig when given
_FLAG_FIELDS = (
    "model", "scene", "probe", "out", "frames", "width", "height", "spp", "max_depth",
    "traversal", "emission_all_bounces", "nee_final_bounce", "nee_rr", "russian_roulette",
    "rr_start_depth", "sampling", "sampling_strata", "fused_foveation", "demand_textures",
    "instanced", "adaptive", "adaptive_fraction", "denoise", "tonemap", "exposure",
    "checkpoint", "metrics",
)


def add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", default="", help="JSON RunConfig file")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to render on (default cuda; there is no fallback: "
             "without a card pass --device cpu)")
    parser.add_argument("--model", default=None, choices=[
        "hello_raytracing", "whitted", "disney_pt", "spectral", "foveated"],
        help="model preset (default disney_pt)")
    parser.add_argument("--scene", default=None)
    parser.add_argument("--probe", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--spp", type=int, default=None)
    parser.add_argument("--max-depth", type=int, default=None, dest="max_depth")
    parser.add_argument(
        "--traversal", default=None, choices=["lockstep", "bfs", "cluster", "dense"],
        help="traversal backend; without it, the cluster walk on a CUDA device "
             "(kernels K1-K4) and the lockstep walk on a CPU")
    parser.add_argument(
        "--emission-all-bounces", action="store_true", default=None,
        dest="emission_all_bounces",
        help="let emissive geometry light the scene through BSDF paths "
             "(needed for closed interiors, e.g. scenes/loft.obj)")
    parser.add_argument(
        "--no-nee-final-bounce", action="store_false", default=None, dest="nee_final_bounce",
        help="skip the final bounce's NEE shadow sweep (the reference traces it "
             "then discards the contribution)")
    parser.add_argument(
        "--nee-rr", type=float, default=None, dest="nee_rr",
        help="unbiased Russian-roulette shadow-ray scheduling threshold "
             "(potential-contribution luminance; 0 = always trace)")
    parser.add_argument(
        "--russian-roulette", action="store_true", default=None, dest="russian_roulette",
        help="throughput-proportional Russian-roulette path termination after "
             "--rr-start-depth bounces (unbiased)")
    parser.add_argument(
        "--rr-start-depth", type=int, default=None, dest="rr_start_depth", metavar="D",
        help="first bounce depth roulette applies to (default 2)")
    parser.add_argument(
        "--sampling", default=None, choices=["random", "stratified", "blue", "sobol"],
        help="sampling strategy for the variance-dominant 2D draws (all unbiased)")
    parser.add_argument(
        "--sampling-strata", type=int, default=None, dest="sampling_strata", metavar="M",
        help="strata / blue-noise points per pixel epoch (perfect square; default 64)")
    parser.add_argument(
        "--instanced", action="store_true", default=None,
        help="glTF: store each reused mesh once and trace it through the "
             "multi-prototype TLAS (per-node transforms) instead of baking "
             "duplicated world-space geometry")
    parser.add_argument(
        "--demand-textures", type=int, default=None, dest="demand_textures",
        metavar="CAPACITY",
        help="shade textures from a demand-loaded tile pool of this capacity "
             "(disney_pt; render builds 4 mip levels, view one)")
    parser.add_argument(
        "--adaptive", action="store_true", default=None,
        help="disney_pt: variance-guided adaptive sampling (frame 1 is a uniform "
             "warm-up, every further frame refines the highest-variance tiles)")
    parser.add_argument(
        "--adaptive-fraction", type=float, default=None, dest="adaptive_fraction",
        metavar="F", help="fraction of tiles refined per adaptive round (default 0.25)")
    parser.add_argument("--denoise", action="store_true", default=None)
    parser.add_argument("--tonemap", default=None, choices=["none", "sqrt", "reinhard"])
    parser.add_argument("--exposure", type=float, default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--metrics", default=None)
    parser.add_argument("--eye", type=float, nargs=3, default=None)
    parser.add_argument("--lookat", type=float, nargs=3, default=None)
    parser.add_argument("--fov-y", type=float, default=None, dest="fov_y")
    parser.add_argument("--gaze", type=int, nargs=2, default=None)
    parser.add_argument(
        "--fused-foveation", action=argparse.BooleanOptionalAction, default=None,
        dest="fused_foveation",
        help="trace all foveation zones in one wavefront launch; "
             "--no-fused-foveation forces three launches; default: the preset's rule")


def config_from_args(args: argparse.Namespace) -> RunConfig:
    """A JSON `--config` file (if given), then every flag given on top."""
    cfg = RunConfig()
    if args.config:
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read())
    for field in _FLAG_FIELDS:
        v = getattr(args, field, None)
        if v is not None:
            setattr(cfg, field, v)
    if args.eye is not None:
        cfg.camera.eye = tuple(args.eye)
    if args.lookat is not None:
        cfg.camera.lookat = tuple(args.lookat)
    if args.fov_y is not None:
        cfg.camera.fov_y = args.fov_y
    if args.gaze is not None:
        cfg.gaze = tuple(args.gaze)
    return cfg
