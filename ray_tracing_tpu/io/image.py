"""Image IO: cubemap loading, PNG screenshots.

Replaces the reference's stb_image / stb_image_write usage
(src/gpu_and_windowing.c:24-33 JPEG decode; src/main.c:637-681 PNG write).
PNGs are encoded with the standard library (zlib + struct) or the native
encoder; only the optional JPEG skybox decode needs PIL. Device code never
touches files.
"""

from __future__ import annotations

import os
import pathlib
import struct
import zlib

import numpy as np

from ray_tracing_tpu.ops.cubemap import (
    CF_BACK,
    CF_BOTTOM,
    CF_FRONT,
    CF_LEFT,
    CF_RIGHT,
    CF_TOP,
    CubemapData,
)

# Default skybox paths relative to an asset root (src/main.c:500-507).
SKYBOX_FILES = {
    CF_RIGHT: "skybox/right.jpg",
    CF_LEFT: "skybox/left.jpg",
    CF_TOP: "skybox/top.jpg",
    CF_BOTTOM: "skybox/bottom.jpg",
    CF_FRONT: "skybox/front.jpg",
    CF_BACK: "skybox/back.jpg",
}

def load_image(path) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_cubemap(asset_root: str | os.PathLike) -> CubemapData:
    """Load the 6-face JPEG skybox under `asset_root` in reference face
    order (src/main.c:500-508)."""
    root = pathlib.Path(asset_root)
    faces = [load_image(root / SKYBOX_FILES[face]) for face in range(6)]
    return CubemapData.from_faces(np.stack(faces))


def encode_png(arr) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0, zlib level 6),
    with the standard library only."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint8))
    h, w = a.shape[0], a.shape[1]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), a.reshape(h, w * 3)], axis=1
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with the reference's conversion: x*255 truncated
    (src/main.c:666-670)."""
    img = np.asarray(img, np.float32)
    return (img * 255.0).astype(np.uint8)


def save_png(img, path, flip_vertically: bool = True, use_native: bool = True) -> None:
    """Write an (H, W, 3) float [0,1] frame as PNG.

    flip_vertically=True matches the reference screenshot path
    (stbi_flip_vertically_on_write, src/main.c:672): our row 0 is the
    reference's row 0, and its writer flips rows on save.

    The C++ encoder (native/rt_native.cpp rt_write_png, the framework's
    stb_image_write equivalent) is used when available; encode_png
    otherwise.
    """
    import ctypes

    arr = to_uint8(img)
    if use_native:
        from ray_tracing_tpu import native

        lib = native.lib()
        if lib is not None:
            a = np.ascontiguousarray(arr)
            rc = lib.rt_write_png(
                str(path).encode(),
                a.shape[1],
                a.shape[0],
                a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                1 if flip_vertically else 0,
            )
            if rc == 0:
                return
    if flip_vertically:
        arr = arr[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def next_screenshot_path(directory=".") -> str | None:
    """First free screenshot_<i>.png for i < 1000 (src/main.c:642-659)."""
    for i in range(1000):
        path = os.path.join(directory, f"screenshot_{i}.png")
        if not os.path.exists(path):
            return path
    return None


def screenshot(img, directory=".") -> str | None:
    """Save the frame like the reference's SPACE handler (src/main.c:637-681)."""
    path = next_screenshot_path(directory)
    if path is not None:
        save_png(img, path, flip_vertically=True)
    return path
