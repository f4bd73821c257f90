"""io/image tests: the skybox loader and the standard-library PNG encoder."""

import pathlib
import struct
import zlib

import numpy as np
import pytest

from ray_tracing_tpu.io.image import (
    SKYBOX_FILES, encode_png, load_cubemap, save_png,
)


def _write_faces(root: pathlib.Path, base: int):
    """Six solid-color JPEG faces, distinct per face and per `base`."""
    from PIL import Image

    (root / "skybox").mkdir(parents=True, exist_ok=True)
    for face, rel in SKYBOX_FILES.items():
        img = Image.new("RGB", (8, 8), (base + 20 * face, base, 255 - base))
        img.save(root / rel, quality=95)


def test_load_cubemap_memoization_and_invalidation(tmp_path):
    """Loading is deterministic (bit-identical texels on a reload), and
    editing an asset must show up on the next load: the loader keeps no
    copy of its own anywhere outside the checkout."""
    _write_faces(tmp_path, base=40)

    first = load_cubemap(tmp_path)
    again = load_cubemap(tmp_path)
    assert first.packed is not None and (first.h, first.w) == (8, 8)
    np.testing.assert_array_equal(np.asarray(first.packed),
                                  np.asarray(again.packed))

    _write_faces(tmp_path, base=200)
    reloaded = load_cubemap(tmp_path)
    assert not np.array_equal(np.asarray(reloaded.packed),
                              np.asarray(first.packed))


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for encode_png's output (8-bit RGB, filter 0)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    assert (depth, color) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()  # filter type 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (32, 48)])
def test_encode_png_round_trip(shape):
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    np.testing.assert_array_equal(_decode_png(encode_png(arr)), arr)


def test_encode_png_readable_by_pil():
    from PIL import Image
    import io

    arr = np.arange(5 * 6 * 3, dtype=np.uint8).reshape(5, 6, 3)
    with Image.open(io.BytesIO(encode_png(arr))) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), arr)


def test_save_png_fallback_flips_rows(tmp_path):
    """save_png without the native encoder writes through encode_png, with
    the reference's vertical flip and x*255 truncation."""
    img = np.zeros((4, 3, 3), np.float32)
    img[0] = 1.0                      # top row white in the frame
    path = tmp_path / "f.png"
    save_png(img, path, use_native=False)
    got = _decode_png(path.read_bytes())
    assert (got[-1] == 255).all() and (got[:-1] == 0).all()
