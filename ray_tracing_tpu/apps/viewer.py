"""Interactive terminal viewer — the reference's GLFW window + event loop
(src/main.c:520-574, src/gpu_and_windowing.c) re-imagined for a headless
accelerator host: frames render on-device with progressive refinement and are
painted into the terminal with ANSI half-block cells; input is raw-mode
keyboard (WASD move, arrows/IJKL look, SPACE screenshot, Q/ESC quit).

Event model mirrors the reference: a host event queue is drained each
frame (pop_event, src/gpu_and_windowing.c:231-246); any camera event
invalidates the accumulation (here: fresh Film + progressive restart at
init_scale, matching invalidate_accumulation src/main.c:115-124 and the
worker scale reset src/main.c:405-408).
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

from ray_tracing_tpu.config import RenderConfig
from ray_tracing_tpu.render import camera as cam_mod
from ray_tracing_tpu.render.film import Film, progressive_scales
from ray_tracing_tpu.io.image import screenshot

# Event ids (analogous to src/gpu_and_windowing.h:18-33)
EV_QUIT, EV_W, EV_A, EV_S, EV_D, EV_LOOK, EV_SHOT, EV_MOUSE = range(8)

_LOOK_KEYS = {
    "i": (0, 60.0), "k": (0, -60.0), "j": (-60.0, 0), "l": (60.0, 0),
    "\x1b[A": (0, 60.0), "\x1b[B": (0, -60.0), "\x1b[D": (-60.0, 0), "\x1b[C": (60.0, 0),
}


_pending = ""  # carry partial escape sequences across polls
_pending_age = 0  # polls a lone ESC has waited for a continuation


def poll_events(timeout: float = 0.0):
    """Drain pending keyboard input into an event list (non-blocking).

    Escape sequences can split across reads (arrow-key autorepeat streams
    3-byte sequences through fixed-size reads), so a trailing partial
    "\\x1b" / "\\x1b[" is carried to the next poll instead of being
    misread as a bare ESC (= quit)."""
    global _pending, _pending_age
    events = []
    buf = _pending
    _pending = ""
    got_new = False
    while select.select([sys.stdin], [], [], timeout)[0]:
        timeout = 0.0
        # latin-1: 1 byte == 1 char, lossless. X10 mouse payloads carry
        # raw bytes >= 0x80 for coordinates > 95; a utf-8 decode would
        # silently drop them and shift the parse frame.
        ch = os.read(sys.stdin.fileno(), 64).decode("latin-1")
        if not ch:
            break
        buf += ch
        got_new = True
    if buf == "\x1b" and not got_new:
        # a lone ESC that nothing followed: it really was the ESC key
        _pending_age += 1
        if _pending_age >= 2:
            _pending_age = 0
            return [(EV_QUIT, None)]
        _pending = buf
        return events
    _pending_age = 0
    ch = buf
    i = 0
    while i < len(ch):
        c = ch[i]
        if c == "\x1b":
            nxt = ch[i + 1] if i + 1 < len(ch) else ""
            if nxt == "":
                _pending = ch[i:]  # lone ESC at buffer end: wait/age
                break
            if nxt == "[":
                # CSI: parameters/intermediates, then one final byte @..~
                j = i + 2
                while j < len(ch) and not ("@" <= ch[j] <= "~"):
                    j += 1
                if j >= len(ch):
                    _pending = ch[i:]  # incomplete CSI: wait for the rest
                    break
                seq = ch[i : j + 1]
                if seq == "\x1b[M":
                    # X10 mouse report: ESC [ M + 3 raw payload bytes
                    # (button+32, x+32, y+32). Terminals without SGR-1006
                    # answer ?1003h in this encoding; the payload bytes are
                    # printable and MUST NOT fall through to the key switch
                    # (they would inject spurious WASD moves or even quit).
                    if j + 4 > len(ch):
                        _pending = ch[i:]  # payload split across reads
                        break
                    b, x, y = (ord(t) - 32 for t in ch[j + 1 : j + 4])
                    if b & 32:  # motion
                        events.append((EV_MOUSE, (float(x), float(y))))
                    i = j + 4
                    continue
                if seq in _LOOK_KEYS:
                    events.append((EV_LOOK, _LOOK_KEYS[seq]))
                elif seq.startswith("\x1b[<") and seq[-1] in "Mm":
                    # SGR-1006 mouse report "<b;x;y[Mm]" — continuous
                    # mouse-look (the reference's MOVE_MOUSE stream,
                    # src/gpu_and_windowing.c:266-269)
                    try:
                        b, x, y = (int(t) for t in seq[3:-1].split(";"))
                        if b & 32:  # motion
                            events.append((EV_MOUSE, (float(x), float(y))))
                    except ValueError:
                        pass
                i = j + 1  # other CSI (modifiers, F5+): swallow
                continue
            if nxt == "O":
                i += 3  # SS3 (F1-F4 etc.): swallow the 3-byte sequence
                continue
            # ESC followed by a plain key: treat as the ESC key (quit)
            events.append((EV_QUIT, None))
            i += 1
            continue
        lc = c.lower()
        if lc == "q" or c == "\x1b":
            events.append((EV_QUIT, None))
        elif lc == "w":
            events.append((EV_W, None))
        elif lc == "a":
            events.append((EV_A, None))
        elif lc == "s":
            events.append((EV_S, None))
        elif lc == "d":
            events.append((EV_D, None))
        elif lc in _LOOK_KEYS:
            events.append((EV_LOOK, _LOOK_KEYS[lc]))
        elif c == " ":
            events.append((EV_SHOT, None))
        i += 1
    return events


_BYTE_STRS = [str(v) for v in range(256)]


def frame_to_ansi(img: np.ndarray) -> str:
    """(H, W, 3) float -> ANSI 24-bit half-block string (2 rows per cell).

    Vectorized-ish assembly: one list comprehension over cells using
    precomputed byte strings (the naive per-cell f-string version dominated
    interactive frame time at viewer sizes)."""
    h = img.shape[0] - (img.shape[0] % 2)
    u8 = np.clip(img[:h] * 255.0, 0, 255).astype(np.uint8)
    top, bot = u8[0::2], u8[1::2]
    rows, cols = top.shape[0], top.shape[1]
    t = top.reshape(rows * cols, 3)
    b = bot.reshape(rows * cols, 3)
    s = _BYTE_STRS
    cells = [
        "\x1b[38;2;" + s[tr] + ";" + s[tg] + ";" + s[tb]
        + "m\x1b[48;2;" + s[br] + ";" + s[bg] + ";" + s[bb] + "m▀"
        for (tr, tg, tb), (br, bg, bb) in zip(t.tolist(), b.tolist())
    ]
    lines = [
        "".join(cells[r * cols : (r + 1) * cols]) + "\x1b[0m" for r in range(rows)
    ]
    return "\n".join(lines)


class Viewer:
    """Progressive interactive loop. render_fn(scene, camera, film, key,
    scale) -> film is injected so the CLI can choose XLA or Pallas path."""

    def __init__(self, scene, camera, width, height, config: RenderConfig,
                 render_fn, resolve_fn=None, out=sys.stdout):
        self.scene = scene
        self.camera = camera
        self.width = width
        self.height = height
        self.config = config
        self.render_fn = render_fn
        self.resolve_fn = resolve_fn or (lambda film: np.asarray(film.resolve()))
        self.out = out
        self.film = Film.zero(width, height)
        self.scales = list(progressive_scales(config))
        self.pass_i = 0
        self.frame_count = 0
        # cross-pass sparse sky cache (megakernel.render_image_pallas):
        # a cache-aware render_fn takes a sky_cache kwarg and returns
        # (film, cache); the plain XLA render_fn keeps the old signature
        self.sky_cache = None
        try:
            import inspect

            self._cache_aware = "sky_cache" in inspect.signature(
                render_fn
            ).parameters
        except (TypeError, ValueError):
            self._cache_aware = False

    def invalidate(self):
        # invalidate_accumulation (src/main.c:115-124): zero buffers,
        # restart the scale pyramid. The sky cache stays EXACT across
        # camera moves but its hit rate dies with them — reseed with the
        # film (and resize changes its shape outright).
        self.film = Film.zero(self.width, self.height)
        self.pass_i = 0
        self.sky_cache = None

    def resize(self, width: int, height: int):
        """realloc_frame_buffer semantics (src/main.c:416-448): new buffers
        at the new size, accumulation restarted."""
        if (width, height) == (self.width, self.height):
            return
        self.width, self.height = width, height
        self._cell_px = None  # terminal metrics may have changed
        self.invalidate()

    def fit_terminal(self, max_w: int = 192, max_h: int = 108) -> None:
        """Match the render size to the terminal (2 pixel rows per cell,
        1 line reserved for the HUD)."""
        try:
            size = os.get_terminal_size(self.out.fileno())
        except (OSError, ValueError):
            return
        w = max(16, min(size.columns, max_w))
        h = max(8, min((size.lines - 2) * 2, max_h))
        self.resize(w, h - h % 2)

    def _cell_pixels(self):
        """Screen pixels per terminal cell (TIOCGWINSZ ws_xpixel/ws_ypixel
        when the terminal reports them; a typical 10x20 otherwise). Cached —
        re-probed on resize via invalidate-free attribute reset."""
        cached = getattr(self, "_cell_px", None)
        if cached is not None:
            return cached
        cw, ch = 10.0, 20.0
        try:
            import fcntl
            import struct
            import termios

            ws = fcntl.ioctl(
                self.out.fileno(), termios.TIOCGWINSZ, b"\x00" * 8
            )
            rows, cols, xpx, ypx = struct.unpack("HHHH", ws)
            if cols > 0 and xpx > 0:
                cw = xpx / cols
            if rows > 0 and ypx > 0:
                ch = ypx / rows
        except Exception:
            pass
        self._cell_px = (cw, ch)
        return self._cell_px

    def handle_events(self, events) -> bool:
        """Returns False when the loop should exit."""
        speed = self.config.move_speed
        for ev, arg in events:
            if ev == EV_QUIT:
                return False
            if ev == EV_W:
                self.camera = cam_mod.move(self.camera, cam_mod.UP, speed, self.config)
                self.invalidate()
            elif ev == EV_S:
                self.camera = cam_mod.move(self.camera, cam_mod.DOWN, speed, self.config)
                self.invalidate()
            elif ev == EV_A:
                self.camera = cam_mod.move(self.camera, cam_mod.LEFT, speed, self.config)
                self.invalidate()
            elif ev == EV_D:
                self.camera = cam_mod.move(self.camera, cam_mod.RIGHT, speed, self.config)
                self.invalidate()
            elif ev == EV_LOOK:
                dx, dy = arg
                self.camera = cam_mod.rotate(self.camera, dx, dy, self.config)
                self.invalidate()
            elif ev == EV_MOUSE:
                # continuous mouse-look from absolute positions, with the
                # reference's first-move skip and y-inversion
                # (src/camera.c:44-56: x - last_x, last_y - y)
                x, y = arg
                last = getattr(self, "_mouse_last", None)
                self._mouse_last = (x, y)
                if last is not None:
                    dx, dy = x - last[0], last[1] - y
                    if dx or dy:
                        # SGR/X10 report terminal CELLS; the reference's
                        # rotate_camera expects WINDOW PIXELS at 0.1°/px
                        # (src/camera.c:42-78). Scale by the cell's screen-
                        # pixel size so physical mouse travel feels the
                        # same as in the reference's GLFW window.
                        cw, ch = self._cell_pixels()
                        self.camera = cam_mod.rotate(
                            self.camera, dx * cw, dy * ch, self.config
                        )
                        self.invalidate()
            elif ev == EV_SHOT:
                path = screenshot(self.resolve_fn(self.film))
                print(f"\nTook screenshot! ({path})", file=sys.stderr)
        return True

    def step(self, key):
        """One refinement pass at the current pyramid scale."""
        from ray_tracing_tpu.utils.profiling import RateMeter, rays_per_frame

        if not hasattr(self, "meter"):
            self.meter = RateMeter()
        scale = self.scales[min(self.pass_i, len(self.scales) - 1)]
        if self._cache_aware:
            self.film, self.sky_cache = self.render_fn(
                self.scene, self.camera, self.film, key, scale,
                sky_cache=self.sky_cache,
            )
        else:
            self.film = self.render_fn(
                self.scene, self.camera, self.film, key, scale
            )
        self.meter.add(
            rays_per_frame(self.width // scale, self.height // scale, 1, self.config)
        )
        self.pass_i += 1
        self.frame_count += 1
        return scale

    def draw(self):
        img = self.resolve_fn(self.film)
        hud = ""
        if hasattr(self, "meter"):
            hud = (
                f"\x1b[0m\n pass {self.pass_i}  weight {float(self.film.weight):.2f}"
                f"  {self.meter.format()}  [WASD move  IJKL look  SPACE shot  Q quit]\x1b[K"
            )
        # Row 0 is array-space bottom-of-scene; the reference GL quad shows
        # row 0 at the bottom (assets/screen.vs texcoords) and save_png
        # flips on write — flip here so the live view matches both.
        self.out.write("\x1b[H" + frame_to_ansi(img[::-1]) + hud)
        self.out.flush()


# Native event ids (native/rt_native.cpp) -> viewer events
_NATIVE_MAP = {
    1: (EV_QUIT, None), 3: (EV_QUIT, None),               # CLOSE / ESC
    4: (EV_W, None), 5: (EV_A, None), 6: (EV_S, None), 7: (EV_D, None),
    2: (EV_SHOT, None),
    20: (EV_LOOK, (0, 60.0)), 21: (EV_LOOK, (0, -60.0)),
    22: (EV_LOOK, (-60.0, 0)), 23: (EV_LOOK, (60.0, 0)),
}


class NativeEventSource:
    """C++ ring-buffer event queue fed by a reader thread
    (native/rt_native.cpp, mirroring src/gpu_and_windowing.c:220-269)."""

    def __init__(self, lib, fd):
        self.lib = lib
        if lib.rt_events_start(fd) != 0:
            raise RuntimeError("event reader already running")

    def poll(self):
        import ctypes

        events = []
        while True:
            ev = self.lib.rt_events_pop()
            if ev == 0:
                return events
            if ev == 8:  # EVENT_MOVE_MOUSE: fetch coordinates lazily
                x = ctypes.c_double()
                y = ctypes.c_double()
                self.lib.rt_mouse_pos(ctypes.byref(x), ctypes.byref(y))
                events.append((EV_MOUSE, (x.value, y.value)))
                continue
            mapped = _NATIVE_MAP.get(ev)
            if mapped is not None:
                events.append(mapped)

    def stop(self):
        self.lib.rt_events_stop()


def run_interactive(viewer: Viewer, max_frames=None, use_native: bool = True,
                    auto_resize: bool = False):
    """Raw-terminal main loop (the reference's main loop, src/main.c:520-574).

    Input comes from the C++ event queue when the native library is
    available (use_native), else from Python select() polling.
    """
    import termios
    import tty

    import jax

    from ray_tracing_tpu import native

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    key = jax.random.key(int(time.time()))

    source = None
    if use_native:
        lib = native.lib()
        if lib is not None:
            try:
                source = NativeEventSource(lib, fd)
            except RuntimeError:
                source = None
    try:
        tty.setcbreak(fd)
        # any-motion mouse tracking, SGR-1006 encoding: continuous
        # mouse-look like the reference's GLFW cursor callback
        viewer.out.write("\x1b[?1003h\x1b[?1006h")
        viewer.out.write("\x1b[2J")  # clear
        running = True
        while running and (max_frames is None or viewer.frame_count < max_frames):
            if auto_resize:
                viewer.fit_terminal()
            events = source.poll() if source is not None else poll_events()
            running = viewer.handle_events(events)
            viewer.step(jax.random.fold_in(key, viewer.frame_count))
            viewer.draw()
    finally:
        if source is not None:
            source.stop()
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        viewer.out.write("\x1b[?1003l\x1b[?1006l\x1b[0m\n")
