#!/usr/bin/env python
"""End-to-end interactive latency: injected WASD event -> next DISPLAYED
frame, on the GPU.

The reference's identity is an interactive window (src/main.c:520-574):
event -> invalidate_accumulation -> workers re-render -> update_frame ->
GL blit. Our two display surfaces are measured through their real
transports, on hardware:

  * serve (HTTP MJPEG, apps/serve.py) at the reference's 1280x960
    window size: POST /key 'w' -> (a) the server's own event->published-
    frame stamp (/healthz event_to_frame_ms — the HUD number) and
    (b) the client-observed time to the first /stream part that DIFFERS
    from the pre-event frame (adds the 100 ms stream poll + PNG encode).
  * viewer (ANSI terminal, apps/viewer.py) via a pty at its terminal
    raster (192x108 — terminal displays are raster-bound the way the
    reference is window-bound): send b'w' -> first frame whose HUD reads
    'pass 1' (the post-invalidate pass counter reset).

Both at --init-scale 8 (progressive warm start: first frame is 1/8-res,
the reference's default) and --init-scale 1 (first frame is full-res).

Usage: python benchmarks/interactive_latency.py [--scene scene_2]
          [--trials 5] [--skip-viewer] [--skip-serve]
"""

import argparse
import http.client
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache"))
    return env


def _healthz(port, timeout=5.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
    try:
        conn.request("POST", path, body=body)
        conn.getresponse().read()
    finally:
        conn.close()


class StreamWatcher(threading.Thread):
    """Reads /stream parts, keeping (arrival_time, len(png)) of the latest
    part. Frame identity via content LENGTH + a sparse byte checksum —
    full-byte hashing of 1280x960 PNGs would lag the stream."""

    def __init__(self, port):
        super().__init__(daemon=True)
        self.port = port
        self.latest = (0.0, None)
        self.stop = False

    def run(self):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        buf = b""
        while not self.stop:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            while True:
                hdr = buf.find(b"\r\n\r\n")
                if hdr < 0:
                    break
                head = buf[:hdr].decode(errors="ignore")
                n = None
                for line in head.split("\r\n"):
                    if line.lower().startswith("content-length:"):
                        n = int(line.split(":")[1])
                if n is None or len(buf) < hdr + 4 + n:
                    break
                png = buf[hdr + 4: hdr + 4 + n]
                buf = buf[hdr + 4 + n:]
                sig = (n, png[n // 3: n // 3 + 16], png[2 * n // 3: 2 * n // 3 + 16])
                self.latest = (time.perf_counter(), sig)
        conn.close()


def serve_case(scene, init_scale, trials, width=1280, height=960, port=8431):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tracing_tpu.apps.serve", "--scene", scene,
         "--width", str(width), "--height", str(height),
         "--init-scale", str(init_scale), "--port", str(port)],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    rows = []
    try:
        # wait for startup + every per-scale jit compile to happen once
        deadline = time.time() + 1200
        n_scales = len({max(init_scale >> i, 1) for i in range(8)})
        while time.time() < deadline:
            try:
                h = _healthz(port)
                if h.get("passes", 0) >= n_scales + 2:
                    break
            except Exception:
                pass
            time.sleep(2.0)
        else:
            raise TimeoutError("serve warmup")

        watcher = StreamWatcher(port)
        watcher.start()
        time.sleep(1.0)
        for t in range(trials):
            v0 = _healthz(port).get("event_to_frame_ms")
            _, sig0 = watcher.latest
            t0 = time.perf_counter()
            _post(port, "/key", b"w")
            server_ms = client_ms = None
            while time.perf_counter() - t0 < 120:
                if client_ms is None:
                    at, sig = watcher.latest
                    if at > t0 and sig != sig0:
                        client_ms = (at - t0) * 1e3
                if server_ms is None:
                    v = _healthz(port).get("event_to_frame_ms")
                    if v is not None and v != v0:
                        server_ms = v
                if server_ms is not None and client_ms is not None:
                    break
                time.sleep(0.02)
            rows.append({"trial": t, "server_ms": server_ms,
                         "client_ms": None if client_ms is None
                         else round(client_ms, 1)})
            print(f"  serve init-scale {init_scale} trial {t}: "
                  f"server {server_ms} ms, client {rows[-1]['client_ms']} ms",
                  flush=True)
            time.sleep(2.0)
        watcher.stop = True
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    return rows


_VIEWER_CHILD = r'''
import json, os, pty, sys, threading, time

import jax

init_scale, scene_path, trials = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])

from ray_tracing_tpu import Camera, RenderConfig
from ray_tracing_tpu.apps.cli import make_pallas_render_fn
from ray_tracing_tpu.apps.viewer import EV_W, Viewer
from ray_tracing_tpu.ops.cubemap import noise_sky
from ray_tracing_tpu.scene.parser import parse_scene_file

scene = parse_scene_file(scene_path)
config = RenderConfig(init_scale=init_scale)
rf = make_pallas_render_fn(config, noise_sky(2048))

# the display: a REAL pty, drained by a reader thread (a terminal
# emulator's role) so draw()'s tty write completes like in a live shell
master, slave = pty.openpty()
drained = [0]

def _drain():
    while True:
        try:
            b = os.read(master, 1 << 20)
        except OSError:
            return
        if not b:
            return
        drained[0] += len(b)

threading.Thread(target=_drain, daemon=True).start()
out = os.fdopen(os.dup(slave), "w", buffering=1)

v = Viewer(scene, Camera.default(), 192, 108, config, rf, out=out)
key = jax.random.key(7)

# warm: every pyramid scale compiles once, plus two steady-state frames
for i in range(len(v.scales) + 2):
    v.step(jax.random.fold_in(key, i))
    v.draw()

rows = []
for t in range(trials):
    pre = drained[0]
    t0 = time.perf_counter()
    v.handle_events([(EV_W, None)])          # event -> invalidate
    v.step(jax.random.fold_in(key, 100 + t)) # first pass with new camera
    v.draw()                                  # ANSI frame onto the tty
    while drained[0] <= pre:                  # displayed = read by the terminal
        time.sleep(0.001)
    ms = (time.perf_counter() - t0) * 1e3
    rows.append(round(ms, 1))
    print(f"  trial {t}: {ms:.1f} ms", file=sys.stderr, flush=True)
    v.step(jax.random.fold_in(key, 200 + t))
    v.draw()
print(json.dumps(rows))
'''


def viewer_case(scene, init_scale, trials):
    """In-process viewer loop (the same Viewer.step/draw the CLI runs,
    writing a 192x108 ANSI raster to a drained pty): event ->
    handle_events -> render pass -> film resolve (device->host pull) ->
    ANSI encode -> tty write. The terminal raster is the viewer's real
    display bound (a terminal shows <=~192x108 half-block pixels the way
    the reference's window shows 1280x960); serve covers 1280x960."""
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(_VIEWER_CHILD)
        path = f.name
    proc = subprocess.run(
        [sys.executable, path, str(init_scale), scene, str(trials)],
        env=_env(), capture_output=True, text=True, timeout=1800,
    )
    sys.stderr.write(proc.stderr[-2000:])
    if proc.returncode != 0:
        raise RuntimeError(f"viewer child failed: {proc.stderr[-400:]}")
    ms = json.loads(proc.stdout.strip().splitlines()[-1])
    for t, m in enumerate(ms):
        print(f"  viewer init-scale {init_scale} trial {t}: {m} ms", flush=True)
    return [{"trial": t, "ms": m} for t, m in enumerate(ms)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=os.path.join(REPO, "scenes", "scene_2.txt"))
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--skip-viewer", action="store_true")
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument("--scales", default="8,1")
    args = ap.parse_args()

    out = {}
    for s in [int(x) for x in args.scales.split(",")]:
        if not args.skip_serve:
            print(f"serve 1280x960 init-scale {s}:", flush=True)
            try:
                out[f"serve_is{s}"] = serve_case(args.scene, s, args.trials)
            except Exception as e:
                print(f"  FAILED: {e}", flush=True)
                out[f"serve_is{s}"] = {"error": str(e)}
        if not args.skip_viewer:
            print(f"viewer 192x108 init-scale {s}:", flush=True)
            try:
                out[f"viewer_is{s}"] = viewer_case(args.scene, s, args.trials)
            except Exception as e:
                print(f"  FAILED: {e}", flush=True)
                out[f"viewer_is{s}"] = {"error": str(e)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
