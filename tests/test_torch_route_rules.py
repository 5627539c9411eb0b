"""The port's two route rules, pinned at the values measured on the H100
(PERF.md §6, tables "C.3 (a)" and "C.3 (b)"; the measuring script is
route_thresholds.py at the repository root):

- `make_foveated_renderer(fused=None)` fuses the three zones into one
  launch at every size measured (640x480 to 3840x2160), where the reference
  fuses only up to 1024x768;
- `closest_hit_cluster` / `any_hit_cluster` with `hier=None` take the node
  walk from 8 entries on: it won every frame measured from 8 entries (the
  city at 1250 boxes) to 4239, and tied the flat walk at the open scene's
  one entry, where the reference waits for 3072.

The route tests run on small CPU stand-ins: a scene object that has only an
entry count, with both walks replaced by markers.
"""
import pytest
import torch

from optixpathtracer_tpu_torch import scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.engine.foveated import FoveationConfig
from optixpathtracer_tpu_torch.models import make_foveated_renderer
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

CPU = torch.device("cpu")
# (width, height, inner radius, outer radius, fovea spp): the sizes measured
FOV_SIZES = [(640, 480, 34, 114, 4), (1280, 720, 52, 171, 8), (1920, 1080, 78, 257, 8),
             (3840, 2160, 157, 515, 8)]
NODE_WINS = [8, 19, 37, 74, 657, 1169, 2192, 4239]  # the city at 1250 / 3125 / 6250 / 12500
#   boxes, build_big_scene at terrain grids (1024, 512) .. (2048, 2048)
TIE = 1  # the open scene of the golden renders


@pytest.fixture(scope="module")
def open_scene():
    return compile_scene(scenes.open_scene(), CPU), scenes.sky_probe(CPU)


@pytest.mark.parametrize("width, height, inner, outer, fovea_spp", FOV_SIZES)
def test_foveated_preset_fuses_at_every_measured_size(open_scene, width, height, inner, outer, fovea_spp):
    cs, probe = open_scene
    fov = FoveationConfig(inner_radius=inner, outer_radius=outer, fovea_spp=fovea_spp)
    r = make_foveated_renderer(cs, probe, scenes.open_camera(width, height), width=width, height=height,
                               foveation=fov)
    assert r.fused is True
    three = make_foveated_renderer(cs, probe, scenes.open_camera(width, height), width=width,
                                   height=height, foveation=fov, fused=False)
    assert three.fused is False  # an explicit choice still holds


class _Flat(Exception):
    """Raised by the stand-in flat walk."""


class _StandIn:
    """A cluster set with only an entry count: enough for the route rule."""

    def __init__(self, num_entries):
        self.num_entries = num_entries


def _route(monkeypatch, entries, query):
    def flat(*args, **kwargs):
        raise _Flat

    monkeypatch.setattr(tc, "closest_hit_cluster_hier", lambda *a, **k: "node")
    monkeypatch.setattr(tc, "any_hit_cluster_hier", lambda *a, **k: "node")
    monkeypatch.setattr(tc, "block_cull", flat)
    try:
        return query(_StandIn(entries), None, None)
    except _Flat:
        return "flat"


@pytest.mark.parametrize("query", [tc.closest_hit_cluster, tc.any_hit_cluster], ids=["closest", "any"])
@pytest.mark.parametrize("entries", NODE_WINS)
def test_hier_none_takes_the_node_walk_on_every_measured_scene(monkeypatch, query, entries):
    assert tc.HIER_MIN_ENTRIES == NODE_WINS[0]
    assert _route(monkeypatch, entries, query) == "node"


@pytest.mark.parametrize("query", [tc.closest_hit_cluster, tc.any_hit_cluster], ids=["closest", "any"])
def test_hier_none_keeps_the_flat_walk_below_the_city(monkeypatch, query):
    # below the smallest scene the node walk won: the flat walk, which tied
    # it at one entry
    assert _route(monkeypatch, NODE_WINS[0] - 1, query) == "flat"
    assert _route(monkeypatch, TIE, query) == "flat"
