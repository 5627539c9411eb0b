"""Port parity, the command line: `utils/config` (the cases of
tests/test_config.py, and a config file written by either package loading
in the other), `utils/logging` (the JSONL rows' keys), `utils/validation`,
the port of test_cli_sampling_flag_reaches_the_engine, the hello_raytracing,
whitted and spectral models rendering, the unported flags raising with
their ROADMAP item, `--profile`, the device rule (no
fallback), `render --demand-textures` (its page count that of the JAX
pager on the same scene) and `view`, and `python -m
optixpathtracer_tpu_torch render --device cpu` in a process that never
imports jax, the JAX package or PIL. The images of the two command lines
are compared in tests/test_torch_cli_parity.py.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from optixpathtracer_tpu.engine.foveated import FoveationConfig as JFoveationConfig
from optixpathtracer_tpu.utils import config as jconfig
from optixpathtracer_tpu.utils import logging as jlogging
from optixpathtracer_tpu_torch import cli, scenes
from optixpathtracer_tpu_torch.engine.foveated import FoveationConfig
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.io.image import read_rgb8
from optixpathtracer_tpu_torch.utils import config, logging, validation

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width", "48", "--height", "32", "--spp", "1", "--max-depth", "1"]


def _parse(mod, argv):
    parser = argparse.ArgumentParser()
    mod.add_config_args(parser)
    return mod.config_from_args(parser.parse_args(argv))


def test_runconfig_json_roundtrip():
    cfg = config.RunConfig(model="foveated", scene="x.obj", spp=7, width=320, height=200,
                           foveation=FoveationConfig(inner_radius=42))
    cfg.camera.eye = (1.0, 2.0, 3.0)
    back = config.RunConfig.from_json(cfg.to_json())
    assert back == cfg
    assert back.foveation.inner_radius == 42 and tuple(back.camera.eye) == (1.0, 2.0, 3.0)


def test_runconfig_fields_and_defaults_are_the_references():
    mine = {f.name: f.default for f in dataclasses.fields(config.RunConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jconfig.RunConfig)}
    assert mine == ref
    assert dataclasses.asdict(config.CameraSpec()) == dataclasses.asdict(jconfig.CameraSpec())
    assert json.loads(config.RunConfig().to_json()) == json.loads(jconfig.RunConfig().to_json())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_file_loads_in_both_packages(tmp_path, writer):
    kw = dict(model="foveated", scene="a.glb", spp=3, instanced=True, nee_rr=0.25, gaze=(10, 20),
              fused_foveation=False, sampling="sobol", adaptive_fraction=0.5)
    src = config if writer == "port" else jconfig
    fov = FoveationConfig if writer == "port" else JFoveationConfig
    cfg = src.RunConfig(**kw, foveation=fov(fovea_spp=4, progressive=True))
    cfg.camera.fov_y = 50.0
    path = tmp_path / "c.json"
    path.write_text(cfg.to_json())
    for mod in (config, jconfig):
        got = _parse(mod, ["--config", str(path)])
        assert json.loads(got.to_json()) == json.loads(cfg.to_json())


def test_cli_overrides_config(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(config.RunConfig(model="whitted", spp=3).to_json())
    cfg = _parse(config, ["--config", str(p), "--spp", "9", "--width", "64", "--eye", "1", "2", "3"])
    assert cfg.model == "whitted" and cfg.spp == 9 and cfg.width == 64
    assert cfg.camera.eye == (1.0, 2.0, 3.0)


def test_every_flag_parses_as_in_the_reference():
    argv = ["--model", "foveated", "--scene", "s.obj", "--probe", "p.hdr", "--out", "o.png",
            "--frames", "3", "--width", "64", "--height", "48", "--spp", "2", "--max-depth", "3",
            "--traversal", "cluster", "--emission-all-bounces", "--no-nee-final-bounce",
            "--nee-rr", "0.5", "--russian-roulette", "--rr-start-depth", "3", "--sampling", "blue",
            "--sampling-strata", "16", "--instanced", "--demand-textures", "8", "--adaptive",
            "--adaptive-fraction", "0.5", "--denoise", "--tonemap", "sqrt", "--exposure", "1.5",
            "--checkpoint", "ck", "--metrics", "m.jsonl", "--eye", "1", "2", "3", "--lookat", "0", "1",
            "0", "--fov-y", "40", "--gaze", "5", "6", "--fused-foveation"]
    assert json.loads(_parse(config, argv).to_json()) == json.loads(_parse(jconfig, argv).to_json())


def test_render_config_factory():
    rc = config.RunConfig(width=100, height=50, spp=2, max_depth=3, traversal="cluster", nee_rr=0.3)
    cfg = rc.render_config(fused_shadows=True)
    assert isinstance(cfg, RenderConfig)
    assert (cfg.width, cfg.height, cfg.samples_per_launch, cfg.max_depth) == (100, 50, 2, 3)
    assert cfg.traversal == "cluster" and cfg.nee_rr == 0.3 and cfg.fused_shadows
    want = jconfig.RunConfig(width=100, height=50, spp=2, max_depth=3, traversal="cluster",
                             nee_rr=0.3).render_config(fused_shadows=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def test_fused_foveation_tri_state():
    for argv, want in ([["--fused-foveation"], True], [["--no-fused-foveation"], False], [[], None]):
        assert _parse(config, argv).fused_foveation is want, argv


def test_device_flag_is_the_ports_own():
    assert _parse(config, []).fused_foveation is None
    parser = argparse.ArgumentParser()
    config.add_config_args(parser)
    assert parser.parse_args([]).device == "cuda"
    assert parser.parse_args(["--device", "cpu"]).device == "cpu"


def test_frame_log_rows_have_the_references_keys(tmp_path):
    rows = {}
    for name, mod in (("port", logging), ("jax", jlogging)):
        path = tmp_path / f"{name}.jsonl"
        log = mod.FrameLog(str(path))
        log.log_frame(render_s=0.25, cursor=(3, 4), spp=4, rays=100.0)
        log.log_frame(state_update_s=0.5)
        assert log.frame_index == 2 and log.display_stats().endswith("frame 2")
        log.close()
        rows[name] = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [set(r) for r in rows["port"]] == [set(r) for r in rows["jax"]]
    for a, b in zip(rows["port"], rows["jax"]):
        assert {k: v for k, v in a.items() if k != "t"} == {k: v for k, v in b.items() if k != "t"}
    assert logging.Timer().lap() >= 0.0


def test_validation(monkeypatch):
    from optixpathtracer_tpu_torch.core.math import Vec3

    bad = torch.tensor([1.0, float("nan")])
    assert validation.validate(bad, "x") is bad  # off by default
    with validation.debug_nans():
        with pytest.raises(FloatingPointError, match="x.y"):
            validation.validate(Vec3(torch.ones(2), bad, torch.ones(2)), "x")
    monkeypatch.setenv("OPTIXPT_VALIDATE", "1")
    with pytest.raises(FloatingPointError, match="non-finite values in v"):
        validation.validate(bad, "v")
    validation.validate(torch.ones(3), "ok")
    validation.assert_image_ok(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(FloatingPointError, match="negative"):
        validation.assert_image_ok(np.full((2, 2, 3), -1.0, np.float32))
    with pytest.raises(FloatingPointError, match="non-finite"):
        validation.assert_image_ok(np.full((2, 2, 3), np.inf, np.float32))


def _render(tmp_path, name, *argv):
    out = tmp_path / f"{name}.png"
    assert cli.main(["render", "--device", "cpu", *SMALL, *argv, "--out", str(out)]) == 0
    return read_rgb8(str(out)).astype(float)


def test_cli_sampling_flag_reaches_the_engine(tmp_path):
    """tests/test_config.py's regression: --sampling reaches the engine."""
    a = _render(tmp_path, "a", "--sampling", "sobol")
    b = _render(tmp_path, "b", "--sampling", "random")
    c = _render(tmp_path, "c", "--sampling", "sobol")
    assert not np.array_equal(a, b), "--sampling had no effect on the render"
    np.testing.assert_array_equal(a, c)
    assert abs(a.mean() - b.mean()) / b.mean() < 0.1


@pytest.mark.parametrize("model", ["hello_raytracing", "whitted", "spectral"])
def test_model_presets_render(tmp_path, model):
    """`render --model hello_raytracing | whitted | spectral` on the CPU at
    48x32: a PNG of that size, lit; whitted renders its own scene and
    ignores --scene, as the reference does."""
    extra = ["--scene", scenes.LOFT_OBJ] if model == "whitted" else []
    img = _render(tmp_path, model, "--model", model, *extra)
    assert img.shape == (32, 48, 3) and img.max() > 20 and img.std() > 2
    if model == "whitted":  # the preset's scene: the miss colour (0.34, 0.55, 0.85) in sRGB at the top
        np.testing.assert_allclose(img[0, 0], [158, 196, 238], atol=2)


@pytest.mark.parametrize("argv, item", [
    (["--traversal", "lockstep"], "not to port"),
    (["--traversal", "bfs"], "not to port"),
    (["--traversal", "dense"], "not to port"),
])
def test_unported_flags_raise(tmp_path, argv, item):
    """The backends the port used to refuse (`item` names the old refusal)
    now render: the port's PNG and the JAX command line's on the same flags
    within 1 per 8-bit channel."""
    from optixpathtracer_tpu import cli as jcli

    del item
    got = _render(tmp_path, "port", *argv)
    out = tmp_path / "jax.png"
    assert jcli.main(["render", *SMALL, *argv, "--out", str(out)]) == 0
    want = read_rgb8(str(out)).astype(float)
    assert got.shape == want.shape == (32, 48, 3) and want.std() > 1
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("sub, item", [(["bench"], "A.6")])
def test_unported_subcommands_raise(sub, item):
    """The subcommands once unported run now: no NotImplementedError of the
    package names their ROADMAP item. Without a card and without --cpu,
    bench raises for want of a CUDA device; it never carries on on the CPU."""
    pkg = os.path.join(REPO, "optixpathtracer_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert f"({item})" not in text and f"ROADMAP {item}" not in text, f
    if torch.cuda.is_available():
        pytest.skip("a card is present: the subcommand runs in full")
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.main(sub)


def test_demand_textures_keeps_the_references_warnings(tmp_path, capsys):
    """Where the reference ignores --demand-textures it warns and renders."""
    _render(tmp_path, "d", "--demand-textures", "16")  # the procedural boxes: no textures
    assert "scene has no textures" in capsys.readouterr().err


def test_render_demand_textures_pages_are_the_jax_pagers(tmp_path, capsys):
    """`render --demand-textures 64` on the loft at 64x48 shades from a
    4-level pool: the page count it prints is the JAX pager's on the same
    scene (117 for three 256x256 textures), and the frame is lit."""
    from optixpathtracer_tpu.io.demand import DemandTextureManager as JaxManager
    from optixpathtracer_tpu.io.obj import load_obj as jax_load_obj

    img = _render(tmp_path, "dt", "--scene", scenes.LOFT_OBJ, "--emission-all-bounces",
                  "--width", "64", "--height", "48", "--demand-textures", "64")
    want = JaxManager.from_host_scene(jax_load_obj(scenes.LOFT_OBJ), 64, levels=4).num_pages
    assert want == 117
    assert f"demand textures: {want} pages, pool capacity 64" in capsys.readouterr().out
    assert img.shape == (48, 64, 3) and img.max() > 0


def test_view_serves_one_frame_and_exits(capsys):
    """`view --max-frames 1 --port 0`: a free port, one frame, exit 0."""
    assert cli.main(["view", "--device", "cpu", *SMALL, "--max-frames", "1", "--port", "0"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("viewer at http://127.0.0.1:") and not line.endswith(":0/")


def test_instanced_obj_warns_and_renders(tmp_path, capsys):
    img = _render(tmp_path, "o", "--scene", scenes.LOFT_OBJ, "--instanced", "--emission-all-bounces")
    assert "glTF scenes only" in capsys.readouterr().err and img.max() > 0


def test_instanced_gltf_without_mesh_nodes_falls_back(tmp_path, capsys):
    """No mesh node: the reference's warning, then its baked load (which
    finds no triangles either, so the compile refuses the empty scene)."""
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{}]}
    path = tmp_path / "empty.gltf"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="empty scene"):
        _render(tmp_path, "e", "--scene", str(path), "--instanced")
    assert "no mesh nodes" in capsys.readouterr().err


def test_foveated_adaptive_checkpoint_denoise_and_profile(tmp_path):
    fov = _render(tmp_path, "f", "--model", "foveated", "--gaze", "10", "8", "--frames", "2")
    ada = _render(tmp_path, "a", "--adaptive", "--frames", "2")
    ck = str(tmp_path / "ck")
    first = _render(tmp_path, "c1", "--checkpoint", ck)
    assert os.path.exists(ck + ".npz")
    second = _render(tmp_path, "c2", "--checkpoint", ck, "--denoise")  # resumes at subframe 1
    assert np.load(ck + ".npz")["subframe_index"] == 2
    prof = tmp_path / "prof"
    _render(tmp_path, "p", "--profile", str(prof))
    assert (prof / "trace.json").stat().st_size > 0
    for img in (fov, ada, first, second):
        assert img.shape == (32, 48, 3) and img.max() > 0


def test_no_device_no_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        cli.main(["render", *SMALL, "--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_module_entry_point_imports_no_jax_jax_package_or_pil(tmp_path):
    out = tmp_path / "m.png"
    metrics = tmp_path / "m.jsonl"
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = ["optixpathtracer_tpu_torch", "render", "--device", "cpu", *{SMALL!r},
                    "--frames", "2", "--metrics", {str(metrics)!r}, "--out", {str(out)!r}]
        try:
            runpy.run_module("optixpathtracer_tpu_torch", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert not e.code, e.code
        print(*(m in sys.modules for m in ("jax", "optixpathtracer_tpu", "PIL")))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-3:] == ["False", "False", "False"]
    assert read_rgb8(str(out)).shape == (32, 48, 3)
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert len(rows) == 2 and set(rows[0]) == {"i", "state_update_s", "render_s", "display_s",
                                              "cursor_x", "cursor_y", "t", "spp", "rays"}
    # the bench subcommand the same way (on a 4-box city, so the child is quick)
    code = textwrap.dedent("""
        import runpy, sys
        from optixpathtracer_tpu_torch import bench, scenes
        bench._scene = lambda name, small: (scenes.build_city_scene(n_boxes=4), "150k-tri city")
        sys.argv = ["optixpathtracer_tpu_torch", "bench", "--small", "--cpu"]
        try:
            runpy.run_module("optixpathtracer_tpu_torch", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert not e.code, e.code
        print(*(m in sys.modules for m in ("jax", "optixpathtracer_tpu", "PIL")))
    """)
    # two torch threads: all of a machine's threads thrash beside the suite's other workers
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(env, OMP_NUM_THREADS="2"), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[0])["metric"].startswith("Mrays/s incoherent")
    assert proc.stdout.split()[-3:] == ["False", "False", "False"]
