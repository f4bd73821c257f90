"""HTTP render service — remote interactive viewing & serving.

The reference's display is a local GLFW window; an accelerator host is
headless and remote, so the serving equivalent is a tiny HTTP server around
the progressive renderer:

    GET  /            minimal HTML viewer (MJPEG stream + key capture)
    GET  /stream      multipart/x-mixed-replace MJPEG of the live film
    GET  /frame.png   current resolved frame as PNG
    GET  /healthz     JSON health/stats (passes, weight, rays/s, device)
    POST /key         body: one of w,a,s,d,i,j,k,l,space,reset — the
                      reference's event loop over HTTP

    python -m ray_tracing_tpu.apps.serve --scene scenes/room.txt \
        --port 8400 --width 320 --height 240

Single render thread owns the device (the reference's worker pool owned
the frame, src/main.c:324-414); HTTP threads only read the latest resolved
frame under a lock and enqueue events — the same publish/consume split,
with a queue instead of condvars.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ray_tracing_tpu.parallel.render import KERNELS

_PAGE = """<!doctype html><title>ray_tracing_tpu</title>
<body style="background:#111;color:#eee;font-family:monospace">
<h3>ray_tracing_tpu — live render (WASD move, click image for mouse-look,
IJKL look, R reset, ESC releases pointer)</h3>
<img id=v src=/stream style="image-rendering:pixelated;width:640px">
<div id=s></div>
<script>
document.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if ('wasdijkl r'.includes(k)) fetch('/key', {method:'POST', body:k});
});
// Continuous mouse-look: raw pointer deltas, exactly the reference's
// MOVE_MOUSE stream (src/gpu_and_windowing.c:266-269) — batched per
// animation tick so a fast mouse doesn't flood the event queue.
const img = document.getElementById('v');
img.onclick = () => img.requestPointerLock();
let ax = 0, ay = 0;
document.addEventListener('mousemove', e => {
  if (document.pointerLockElement === img) { ax += e.movementX; ay += e.movementY; }
});
setInterval(() => {
  if (ax || ay) { fetch('/look', {method:'POST', body: ax + ' ' + ay}); ax = 0; ay = 0; }
}, 50);
setInterval(async () => {
  const h = await (await fetch('/healthz')).json();
  document.getElementById('s').textContent = JSON.stringify(h);
}, 1000);
</script>"""


class RenderService:
    """Owns the device: progressive passes + event handling in one thread."""

    def __init__(self, scene, width, height, config, cubemap,
                 kernel: str = "auto",
                 film_checkpoint: str | None = None,
                 film_checkpoint_every: int = 64):
        import jax

        from ray_tracing_tpu.parallel.render import resolve_kernel

        from ray_tracing_tpu.render.camera import Camera
        from ray_tracing_tpu.render.film import (
            Film,
            progressive_scales,
            render_pass,
        )
        from ray_tracing_tpu.utils.profiling import RateMeter, rays_per_frame

        self.jax = jax
        self.scene = scene
        self.camera = Camera.default()
        self.width, self.height = width, height
        self.config = config
        self.cubemap = cubemap
        self.film = Film.zero(width, height)
        self.scales = progressive_scales(config)
        self.pass_i = 0
        self.meter = RateMeter()
        self.rays_per_frame = rays_per_frame
        self.events: queue.Queue[str] = queue.Queue(maxsize=512)  # ref ring size
        self.frame_lock = threading.Lock()
        # display frame is uint8: the resolve+quantize runs ON DEVICE so
        # the per-pass device->host pull is 3 bytes/px, not 12
        self.frame = np.zeros((height, width, 3), np.uint8)
        import jax.numpy as jnp

        self._resolve_u8 = jax.jit(
            lambda film: (jnp.clip(film.resolve(), 0.0, 1.0) * 255.0 + 0.5)
            .astype(jnp.uint8))
        self.running = True
        self.passes_done = 0
        # interactive latency: POST arrival -> first PUBLISHED frame that
        # reflects the event (the reference's whole identity is this loop,
        # src/main.c:520-574). Surfaces in /healthz -> the page HUD.
        self._event_arrival = None
        self._lat_start = None
        self.event_to_frame_ms = None
        self.started = time.time()
        self.film_checkpoint = film_checkpoint
        self.film_checkpoint_every = film_checkpoint_every
        self._digest = None
        if film_checkpoint:
            self._restore_film_state()

        self._sky_cache = None
        self.kernel = resolve_kernel(kernel)
        if self.kernel != "xla":
            # same pass policy as the CLI viewer (one tested
            # implementation): full-res passes batch spp=4 and thread
            # the sparse sky cache across passes at the fixed camera;
            # pyramid scales never touch it
            from ray_tracing_tpu.apps.cli import make_pallas_render_fn

            rf = make_pallas_render_fn(
                config, cubemap, interpret=self.kernel == "pallas_interpret")

            def _pass(key, scale):
                film, self._sky_cache = rf(
                    self.scene, self.camera, self.film, key, scale,
                    sky_cache=self._sky_cache)
                return film

            self._pass = _pass
        else:
            import functools

            @functools.partial(jax.jit, static_argnames=("scale",))
            def xfn(scene, camera, film, key, scale):
                return render_pass(scene, camera, film, key, scale, config, cubemap)

            self._pass = lambda key, scale: xfn(
                self.scene, self.camera, self.film, key, scale=scale)

    def invalidate(self):
        from ray_tracing_tpu.render.film import Film

        if self._event_arrival is not None:
            self._lat_start = self._event_arrival
            self._event_arrival = None
        self.film = Film.zero(self.width, self.height)
        self.pass_i = 0
        # the sky cache stays exact across camera moves but its hit rate
        # dies with them — reseed with the film
        self._sky_cache = None

    def handle(self, ev: str):
        from ray_tracing_tpu.render import camera as cam_mod

        moves = {"w": cam_mod.UP, "s": cam_mod.DOWN, "a": cam_mod.LEFT,
                 "d": cam_mod.RIGHT}
        looks = {"i": (0, 60.0), "k": (0, -60.0), "j": (-60.0, 0), "l": (60.0, 0)}
        if ev.startswith("look "):
            # raw pointer deltas: "look <dx> <dy>" with dy in screen-down
            # pixels; rotate() wants screen-up (the reference computes
            # last_y - y, src/camera.c:52), sensitivity 0.1 inside rotate.
            try:
                _, dxs, dys = ev.split()
                dx, dy = float(dxs), -float(dys)
            except ValueError:
                return
            self.camera = cam_mod.rotate(self.camera, dx, dy, self.config)
            self.invalidate()
        elif ev in moves:
            self.camera = cam_mod.move(self.camera, moves[ev],
                                       self.config.move_speed, self.config)
            self.invalidate()
        elif ev in looks:
            dx, dy = looks[ev]
            self.camera = cam_mod.rotate(self.camera, dx, dy, self.config)
            self.invalidate()
        elif ev in ("r", "reset"):
            from ray_tracing_tpu.render.camera import Camera

            self.camera = Camera.default()
            self.invalidate()

    def _film_digest(self):
        """Identity of what the film accumulates: scene geometry/materials,
        physics config, resolution and the SKY (a film lit by a different
        cubemap is stale radiance too). A checkpoint from a different
        identity must NOT be blended into this render (it would display
        stale radiance until the camera moves). The kernel choice
        (pallas/xla) is deliberately excluded: both accumulate the same
        estimator, so mixing their passes stays a valid film. Cached —
        everything hashed is fixed for the service lifetime, and the
        cubemap hash is megabytes of one-time work."""
        if self._digest is not None:
            return self._digest
        import hashlib

        h = hashlib.sha256()
        h.update(np.asarray(self.scene.packed_rows()).tobytes())
        h.update(repr(self.config).encode())
        h.update(np.asarray([self.width, self.height], np.int64).tobytes())
        cm = self.cubemap
        h.update(np.asarray([cm.h, cm.w], np.int64).tobytes())
        for leaf in (cm.packed, cm.r, cm.g, cm.b):
            if leaf is not None:
                h.update(np.asarray(leaf).tobytes())
        self._digest = np.frombuffer(h.digest()[:8], dtype=np.int64)[0]
        return self._digest

    def _restore_film_state(self):
        """Resume a long progressive render across restarts: the Film AND
        the camera pose it was accumulated at are restored together (a
        film is only meaningful for its own pose), gated on the
        scene/config digest matching."""
        import jax.numpy as jnp

        from ray_tracing_tpu.diff.checkpoint import restore_checkpoint

        state = restore_checkpoint(self.film_checkpoint)
        if state is None:
            return
        if "digest" in state and int(np.asarray(state["digest"])) != int(
            self._film_digest()
        ):
            print("Film checkpoint is for a different scene/config; "
                  "starting fresh", file=sys.stderr)
            return
        try:
            import dataclasses

            from ray_tracing_tpu.ops.vec import Vec3
            from ray_tracing_tpu.render.film import Film

            film = Film(
                accum=Vec3(
                    jnp.asarray(state["accum_x"]),
                    jnp.asarray(state["accum_y"]),
                    jnp.asarray(state["accum_z"]),
                ),
                weight=jnp.asarray(state["weight"], jnp.float32),
            )
            if film.accum.shape != (self.height, self.width):
                return  # resolution changed: start fresh
            self.camera = dataclasses.replace(
                self.camera,
                pos=jnp.asarray(state["cam_pos"]),
                front=jnp.asarray(state["cam_front"]),
                up=jnp.asarray(state["cam_up"]),
                yaw=jnp.asarray(state["cam_yaw"], jnp.float32),
                pitch=jnp.asarray(state["cam_pitch"], jnp.float32),
            )
            self.film = film
            self.pass_i = len(self.scales)  # past the pyramid: full-res
            self.passes_done = int(state.get("passes", 0))
            print(f"Resumed film at weight {float(film.weight):.1f} "
                  f"({self.passes_done} passes)", file=sys.stderr)
        except (KeyError, TypeError) as e:
            print(f"Film checkpoint unusable ({e}); starting fresh",
                  file=sys.stderr)

    def _save_film_state(self):
        from ray_tracing_tpu.diff.checkpoint import save_checkpoint

        save_checkpoint(
            self.film_checkpoint,
            {
                "film_tag": np.int32(1),
                "accum_x": self.film.accum.x,
                "accum_y": self.film.accum.y,
                "accum_z": self.film.accum.z,
                "weight": self.film.weight,
                "cam_pos": self.camera.pos,
                "cam_front": self.camera.front,
                "cam_up": self.camera.up,
                "cam_yaw": self.camera.yaw,
                "cam_pitch": self.camera.pitch,
                "passes": np.int32(self.passes_done),
                "digest": self._film_digest(),
            },
            step=0,  # one rolling slot — latest state wins
        )

    def step(self, key):
        """One progressive pass: drain pending events, render at the
        current pyramid scale, publish the resolved uint8 frame."""
        try:
            while True:
                self.handle(self.events.get_nowait())
        except queue.Empty:
            pass
        scale = self.scales[min(self.pass_i, len(self.scales) - 1)]
        self.film = self._pass(key, scale)
        resolved = np.asarray(self._resolve_u8(self.film))
        with self.frame_lock:
            self.frame = resolved
        if self._lat_start is not None:
            self.event_to_frame_ms = round(
                (time.perf_counter() - self._lat_start) * 1e3, 1)
            self._lat_start = None
        self.meter.add(self.rays_per_frame(
            self.width // scale, self.height // scale, 1, self.config))
        self.pass_i += 1
        self.passes_done += 1
        if (
            self.film_checkpoint
            and self.passes_done % self.film_checkpoint_every == 0
        ):
            self._save_film_state()
        return scale

    def run(self):
        key = self.jax.random.key(int(time.time()))
        while self.running:
            self.step(self.jax.random.fold_in(key, self.passes_done))

    def snapshot_png(self) -> bytes:
        from ray_tracing_tpu.io.image import encode_png

        with self.frame_lock:
            # flip to display convention (matches the reference GL quad and
            # io.save_png's vertical flip on write); frame is already u8
            arr = self.frame[::-1].copy()
        return encode_png(arr)

    def stats(self) -> dict:
        return {
            "status": "ok",
            "passes": self.passes_done,
            "film_weight": float(self.film.weight),
            "rays_per_second": self.meter.rays_per_second,
            "uptime_s": round(time.time() - self.started, 1),
            "backend": self.jax.default_backend(),
            "kernel": self.kernel,
            "resolution": [self.width, self.height],
            "event_to_frame_ms": self.event_to_frame_ms,
        }


def make_handler(svc: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/frame.png":
                body = svc.snapshot_png()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/healthz":
                body = json.dumps(svc.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while svc.running:
                        png = svc.snapshot_png()
                        self.wfile.write(b"--frame\r\nContent-Type: image/png\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(png)}\r\n\r\n".encode())
                        self.wfile.write(png)
                        self.wfile.write(b"\r\n")
                        time.sleep(0.1)
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path in ("/key", "/look"):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode(errors="ignore").strip().lower()
                ev = f"look {body}" if self.path == "/look" else body
                try:
                    svc._event_arrival = time.perf_counter()
                    svc.events.put_nowait(ev)
                    code = 200
                except queue.Full:  # ref drops on a full ring too
                    code = 429
                self.send_response(code)
                self.send_header("Content-Length", "0")
                self.end_headers()
            else:
                self.send_error(404)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytrace-serve", description=__doc__)
    p.add_argument("--scene", required=True)
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--init-scale", type=int, default=8, choices=[1, 2, 4, 8, 16])
    p.add_argument("--kernel", choices=KERNELS, default="auto")
    p.add_argument("--no-skybox", action="store_true")
    p.add_argument("--assets", default=None,
                   help="skybox root; default: seeded procedural sky")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--film-checkpoint", default=None,
                   help="directory: save/resume the accumulation state "
                        "(film + camera pose) across restarts")
    args = p.parse_args(argv)

    from ray_tracing_tpu.apps.cli import load_sky
    from ray_tracing_tpu.config import RenderConfig
    from ray_tracing_tpu.scene.parser import parse_scene_file

    scene = parse_scene_file(args.scene)
    config = RenderConfig(init_scale=args.init_scale)
    cubemap = load_sky(args)
    svc = RenderService(scene, args.width, args.height, config, cubemap,
                        kernel=args.kernel,
                        film_checkpoint=args.film_checkpoint)
    render_thread = threading.Thread(target=svc.run, daemon=True)
    render_thread.start()

    server = ThreadingHTTPServer((args.host, args.port), make_handler(svc))
    print(f"Serving on http://{args.host}:{args.port}", file=sys.stderr)

    # SIGTERM (systemd/k8s stop) takes the same graceful path as Ctrl-C so
    # the film tail since the last periodic save is never lost.
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        svc.running = False
        if svc.film_checkpoint:
            # let the in-flight pass land, then save the tail (up to
            # film_checkpoint_every-1 passes since the last periodic save)
            render_thread.join(timeout=30.0)
            svc._save_film_state()
            print("Final film checkpoint saved", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
