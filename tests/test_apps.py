"""CLI + viewer tests (reference UX, src/main.c:484-634 analogue)."""

import io
import os
import sys

import numpy as np
import pytest

import jax

from ray_tracing_tpu import Camera, RenderConfig
from ray_tracing_tpu.apps.cli import build_parser, main as cli_main
from ray_tracing_tpu.apps.viewer import (
    EV_LOOK,
    EV_QUIT,
    EV_SHOT,
    EV_W,
    Viewer,
    frame_to_ansi,
)
from ray_tracing_tpu.ops.cubemap import constant_sky
from ray_tracing_tpu.render.film import render_pass
from ray_tracing_tpu.scene.types import ObjectSpec, Scene

CFG = RenderConfig(bounces=2, shadow_samples=1, init_scale=4)
SKY = constant_sky((0.4, 0.5, 0.6))


def make_viewer(tmp_path=None):
    scene = Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3),
    ])

    def render_fn(scene, camera, film, key, scale):
        return render_pass(scene, camera, film, key, scale, CFG, SKY)

    return Viewer(scene, Camera.default(), 32, 24, CFG, render_fn, out=io.StringIO())


def test_viewer_threads_sky_cache_through_cache_aware_render_fn():
    """A render_fn with a sky_cache kwarg gets the previous pass's cache
    back and its returned cache is stored; invalidation (camera events,
    resize) resets the cache with the film. The plain 5-arg render_fn
    (XLA path) keeps its old contract untouched."""
    scene = Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3),
    ])
    seen = []

    def render_fn(scene, camera, film, key, scale, sky_cache=None):
        seen.append(sky_cache)
        return render_pass(scene, camera, film, key, scale, CFG, SKY), (
            "cache", len(seen)
        )

    v = Viewer(scene, Camera.default(), 32, 24, CFG, render_fn,
               out=io.StringIO())
    assert v._cache_aware and v.sky_cache is None
    key = jax.random.key(0)
    v.step(key)
    v.step(key)
    assert seen == [None, ("cache", 1)]
    assert v.sky_cache == ("cache", 2)
    v.invalidate()
    assert v.sky_cache is None
    v.step(key)
    assert seen[-1] is None

    # the old contract: no kwarg, nothing threaded
    plain = make_viewer()
    assert not plain._cache_aware
    plain.step(key)
    assert plain.sky_cache is None


def test_parser_reference_flags():
    p = build_parser()
    a = p.parse_args(["--scene", "s.txt", "--threads", "16", "--init-scale", "2"])
    assert a.scene == "s.txt"
    assert a.threads == 16
    assert a.init_scale == 2
    with pytest.raises(SystemExit):  # invalid init-scale, like the reference
        p.parse_args(["--scene", "s.txt", "--init-scale", "3"])
    with pytest.raises(SystemExit):  # missing --scene
        p.parse_args([])


def test_cli_bad_scene_returns_error(tmp_path, capsys):
    bad = tmp_path / "bad.txt"
    bad.write_text("pyramid")
    rc = cli_main(["--scene", str(bad), "--output", str(tmp_path / "x.png")])
    assert rc == 1


def test_cli_offline_render(tmp_path):
    scn = tmp_path / "s.txt"
    scn.write_text("sphere\n\tcenter {3 3 3}\n\tradius 1\n")
    out = tmp_path / "out.png"
    rc = cli_main([
        "--scene", str(scn), "--width", "48", "--height", "32", "--spp", "1",
        "--no-skybox", "--kernel", "xla", "--output", str(out),
    ])
    assert rc == 0
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (48, 32)


def test_viewer_progressive_and_invalidation():
    v = make_viewer()
    key = jax.random.key(0)
    # pyramid: 4 -> 2 -> 1, then stays at 1
    assert v.step(key) == 4
    assert v.step(key) == 2
    assert v.step(key) == 1
    assert v.step(key) == 1
    w_before = float(v.film.weight)
    assert w_before == pytest.approx(1 / 16 + 1 / 4 + 2.0)
    # W key: camera moves, accumulation restarts at init_scale
    pos_before = np.asarray(v.camera.pos).copy()
    assert v.handle_events([(EV_W, None)])
    assert float(v.film.weight) == 0.0
    assert v.step(key) == 4
    assert not np.allclose(np.asarray(v.camera.pos), pos_before)
    # look event rotates
    yaw = float(v.camera.yaw)
    v.handle_events([(EV_LOOK, (60.0, 0.0))])
    assert float(v.camera.yaw) == pytest.approx(yaw + 6.0)  # 0.1 sensitivity
    # quit event ends the loop
    assert v.handle_events([(EV_QUIT, None)]) is False


def test_viewer_resize():
    # realloc_frame_buffer semantics: new buffers, accumulation restarted
    v = make_viewer()
    v.step(jax.random.key(0))
    assert float(v.film.weight) > 0
    v.resize(48, 36)
    assert (v.width, v.height) == (48, 36)
    assert float(v.film.weight) == 0.0
    assert v.pass_i == 0
    assert v.step(jax.random.key(1)) == 4  # pyramid restarted
    assert v.film.accum.shape == (36, 48)
    v.resize(48, 36)  # same size: no-op, keeps accumulation
    assert float(v.film.weight) > 0


def test_viewer_screenshot(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    v = make_viewer()
    v.step(jax.random.key(0))
    v.handle_events([(EV_SHOT, None)])
    assert (tmp_path / "screenshot_0.png").exists()
    # second shot picks the next free name (src/main.c:642-659)
    v.handle_events([(EV_SHOT, None)])
    assert (tmp_path / "screenshot_1.png").exists()


def test_frame_to_ansi():
    img = np.zeros((4, 3, 3), np.float32)
    img[0, 0] = [1, 0, 0]
    s = frame_to_ansi(img)
    assert s.count("▀") == 6  # 3 cols x 2 cell-rows
    assert "\x1b[38;2;255;0;0m" in s


CHILD_SCRIPT = r"""
import os, sys, tempfile
import jax
jax.config.update("jax_platforms", "cpu")
os.chdir(tempfile.mkdtemp())
from ray_tracing_tpu import Camera, RenderConfig
from ray_tracing_tpu.apps.viewer import Viewer, run_interactive
from ray_tracing_tpu.ops.cubemap import constant_sky
from ray_tracing_tpu.render.film import render_pass
from ray_tracing_tpu.scene.types import ObjectSpec, Scene

CFG = RenderConfig(bounces=2, shadow_samples=1, init_scale=4)
SKY = constant_sky((0.4, 0.5, 0.6))
scene = Scene.from_objects([ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,)*3)])
fn = lambda s, c, f, k, sc: render_pass(s, c, f, k, sc, CFG, SKY)
v = Viewer(scene, Camera.default(), 32, 24, CFG, fn, out=sys.stdout)
run_interactive(v, max_frames=60)
print("VIEWER-DONE", file=sys.stderr)
"""


def test_run_interactive_pty(tmp_path):
    """Drive the raw-terminal loop through a pseudo-terminal in a fresh
    interpreter: move, screenshot, quit."""
    import pty
    import subprocess
    import time

    script = tmp_path / "child.py"
    script.write_text(CHILD_SCRIPT)
    master, slave = pty.openpty()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        JAX_COMPILATION_CACHE_DIR="/tmp/jax_cache_rtt",
        PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    proc = subprocess.Popen(
        [sys.executable, str(script)],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, env=env,
    )
    os.close(slave)
    time.sleep(20)  # allow compile + a few frames
    os.write(master, b"w")
    time.sleep(2)
    os.write(master, b" ")
    time.sleep(2)
    os.write(master, b"q")
    out = b""
    t0 = time.time()
    while time.time() - t0 < 180 and proc.poll() is None:
        import select as _select

        if _select.select([master], [], [], 1.0)[0]:
            try:
                out += os.read(master, 65536)
            except OSError:
                break
    _, err = proc.communicate(timeout=60)
    os.close(master)
    assert proc.returncode == 0, err[-800:]
    assert b"VIEWER-DONE" in err
    assert b"\x1b[38;2;" in out  # painted pixels
    assert b"Took screenshot" in err


def test_viewer_mouse_look_events():
    """EV_MOUSE absolute positions drive continuous mouse-look with the
    reference's first-move skip, y-inversion, and 0.1 sensitivity
    (src/camera.c:42-78)."""
    import numpy as np

    from ray_tracing_tpu.apps.viewer import EV_MOUSE, Viewer
    from ray_tracing_tpu.config import RenderConfig
    from ray_tracing_tpu.render.camera import Camera
    from ray_tracing_tpu.scene.parser import parse_scene_string

    scene = parse_scene_string("sphere center {0 0 0} radius 1\n")
    cfg = RenderConfig(bounces=1, shadow_samples=1)
    v = Viewer(scene, Camera.default(), 16, 8, cfg,
               render_fn=lambda s, c, f, k, sc: f)
    v._cell_px = (1.0, 1.0)  # raw deltas: cell-to-pixel scaling tested below
    yaw0, pitch0 = float(v.camera.yaw), float(v.camera.pitch)

    # first event only seeds last-position (first_mouse, src/camera.c:44-50)
    assert v.handle_events([(EV_MOUSE, (100.0, 50.0))])
    assert float(v.camera.yaw) == yaw0 and float(v.camera.pitch) == pitch0
    # +30 px right, +10 px down -> yaw += 3.0, pitch -= 1.0
    assert v.handle_events([(EV_MOUSE, (130.0, 60.0))])
    assert float(v.camera.yaw) == pytest.approx(yaw0 + 3.0)
    assert float(v.camera.pitch) == pytest.approx(pitch0 - 1.0)
    # front re-derived from yaw/pitch
    import math
    yr, pr = math.radians(yaw0 + 3.0), math.radians(pitch0 - 1.0)
    np.testing.assert_allclose(
        np.asarray(v.camera.front),
        [math.cos(yr) * math.cos(pr), math.sin(pr), math.sin(yr) * math.cos(pr)],
        atol=1e-6,
    )


def test_viewer_mouse_look_cell_to_pixel_scaling():
    """Terminal mouse reports are CELL-granular; the viewer scales deltas
    by the cell's screen-pixel size so look speed matches the reference's
    0.1 deg-per-window-pixel feel (VERDICT r2 weak #9, src/camera.c:42-78)."""
    from ray_tracing_tpu.apps.viewer import EV_MOUSE, Viewer
    from ray_tracing_tpu.config import RenderConfig
    from ray_tracing_tpu.render.camera import Camera
    from ray_tracing_tpu.scene.parser import parse_scene_string

    scene = parse_scene_string("sphere center {0 0 0} radius 1\n")
    cfg = RenderConfig(bounces=1, shadow_samples=1)
    v = Viewer(scene, Camera.default(), 16, 8, cfg,
               render_fn=lambda s, c, f, k, sc: f)
    v._cell_px = (10.0, 20.0)  # a typical cell: 10x20 screen pixels
    yaw0, pitch0 = float(v.camera.yaw), float(v.camera.pitch)

    assert v.handle_events([(EV_MOUSE, (40.0, 12.0))])  # seed last-position
    # +3 cells right, +1 cell down -> +30 px, +20 px -> yaw +3.0, pitch -2.0
    assert v.handle_events([(EV_MOUSE, (43.0, 13.0))])
    assert float(v.camera.yaw) == pytest.approx(yaw0 + 3.0)
    assert float(v.camera.pitch) == pytest.approx(pitch0 - 2.0)

    # resize invalidates the cached cell metrics (fresh probe next event)
    v.resize(20, 10)
    assert v._cell_px is None


def test_poll_events_parses_sgr_mouse(monkeypatch):
    """The Python fallback parser decodes SGR mouse motion reports."""
    import os as _os

    from ray_tracing_tpu.apps import viewer as vmod

    r, w = _os.pipe()
    _os.write(w, b"\x1b[<35;20;10M\x1b[<35;25;12Mw")
    _os.close(w)

    class FakeStdin:
        def fileno(self):
            return r

    monkeypatch.setattr(vmod.sys, "stdin", FakeStdin())
    vmod._pending = ""
    events = vmod.poll_events(timeout=0.2)
    _os.close(r)
    assert (vmod.EV_MOUSE, (20.0, 10.0)) in events
    assert (vmod.EV_MOUSE, (25.0, 12.0)) in events
    assert (vmod.EV_W, None) in events


def test_poll_events_parses_x10_mouse_payload(monkeypatch):
    """Terminals without SGR-1006 answer ?1003h with X10 reports (ESC[M +
    3 raw bytes). The payload bytes are printable ('q', 'w', ...) and must
    be consumed as mouse data — never fall through to the key switch as
    spurious moves or quit (ADVICE r2)."""
    import os as _os

    from ray_tracing_tpu.apps import viewer as vmod

    r, w = _os.pipe()
    # motion report (b=35 has the 32 bit) at x=81 ('q'+32... payload bytes
    # are chr(32+coord)), then a real 'w' keypress
    payload = bytes([0x1B, ord("["), ord("M"), 32 + 35, 32 + 81, 32 + 17])
    _os.write(w, payload + b"w")
    _os.close(w)

    class FakeStdin:
        def fileno(self):
            return r

    monkeypatch.setattr(vmod.sys, "stdin", FakeStdin())
    vmod._pending = ""
    events = vmod.poll_events(timeout=0.2)
    _os.close(r)
    assert (vmod.EV_MOUSE, (81.0, 17.0)) in events
    assert (vmod.EV_W, None) in events          # the real keypress survives
    assert (vmod.EV_QUIT, None) not in events   # 'q'-looking payload ignored
    assert events.count((vmod.EV_W, None)) == 1  # no payload-injected moves


def test_poll_events_x10_payload_high_coordinates(monkeypatch):
    """X10 coordinates > 95 encode as raw bytes >= 0x80 (not valid UTF-8).
    The byte-lossless decode must keep them: a 132-column report is
    (32+100)=0x84; dropping it would shift the parse frame onto the next
    real keystroke."""
    import os as _os

    from ray_tracing_tpu.apps import viewer as vmod

    r, w = _os.pipe()
    payload = bytes([0x1B, ord("["), ord("M"), 32 + 35, 32 + 100, 32 + 130])
    _os.write(w, payload + b"w")
    _os.close(w)

    class FakeStdin:
        def fileno(self):
            return r

    monkeypatch.setattr(vmod.sys, "stdin", FakeStdin())
    vmod._pending = ""
    events = vmod.poll_events(timeout=0.2)
    _os.close(r)
    assert (vmod.EV_MOUSE, (100.0, 130.0)) in events
    assert events.count((vmod.EV_W, None)) == 1
    assert (vmod.EV_QUIT, None) not in events


def test_poll_events_x10_payload_split_across_reads(monkeypatch):
    """A split X10 payload waits for its continuation (carry buffer)."""
    import os as _os

    from ray_tracing_tpu.apps import viewer as vmod

    class FakeStdin:
        def __init__(self, fd):
            self._fd = fd

        def fileno(self):
            return self._fd

    r, w = _os.pipe()
    _os.write(w, bytes([0x1B, ord("["), ord("M"), 32 + 35]))  # cut mid-payload
    monkeypatch.setattr(vmod.sys, "stdin", FakeStdin(r))
    vmod._pending = ""
    events = vmod.poll_events(timeout=0.2)
    assert events == []
    _os.write(w, bytes([32 + 5, 32 + 6]))
    _os.close(w)
    events = vmod.poll_events(timeout=0.2)
    _os.close(r)
    assert (vmod.EV_MOUSE, (5.0, 6.0)) in events


def test_cli_pallas_render_fn_cache_contract(monkeypatch):
    """cli.make_pallas_render_fn drives the Viewer's cache-aware contract:
    pyramid passes pass the cache through untouched, full-res passes seed
    and thread it, invalidation drops it. render_pass_pallas is replaced
    by a traceable stand-in (its real cache semantics are pinned in
    test_megakernel.py)."""
    import jax.numpy as jnp

    from ray_tracing_tpu.apps.cli import make_pallas_render_fn
    from ray_tracing_tpu.render import film as film_mod
    from ray_tracing_tpu.render.film import render_pass

    calls = []

    def fake_render_pass_pallas(scene, camera, film, seed, scale, config,
                                cubemap, spp=1, sky_cache=None,
                                return_sky_cache=False, interpret=False):
        assert return_sky_cache
        calls.append((scale, spp, sky_cache is not None))
        out = render_pass(scene, camera, film, jax.random.key(0), scale,
                          config, cubemap)
        prev = sky_cache[0] if sky_cache is not None else jnp.int32(0)
        return out, (prev + 1,)

    monkeypatch.setattr(film_mod, "render_pass_pallas",
                        fake_render_pass_pallas)

    scene = Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3),
    ])
    cfg = RenderConfig(bounces=2, shadow_samples=1, init_scale=2)
    render_fn = make_pallas_render_fn(cfg, SKY)
    v = Viewer(scene, Camera.default(), 32, 24, cfg, render_fn,
               out=io.StringIO())
    assert v._cache_aware

    key = jax.random.key(2)
    v.step(key)                      # scale 2: pyramid, cache untouched
    assert v.sky_cache is None
    v.step(key)                      # scale 1: seeds
    assert int(v.sky_cache[0]) == 1
    v.step(key)                      # scale 1: threads
    assert int(v.sky_cache[0]) == 2
    assert calls == [(2, 1, False), (1, 4, False), (1, 4, True)]

    v.invalidate()
    assert v.sky_cache is None
