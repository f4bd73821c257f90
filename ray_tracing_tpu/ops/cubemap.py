"""Cubemap skybox sampling.

Reproduces the reference's dominant-axis face selection, per-face (u,v)
formulas, [-1,1] clamp, and nearest-texel lookup
(src/gpu_and_windowing.c:42-112).

Storage: 8-bit cubemaps are packed into ONE uint32 plane
(r<<16 | g<<8 | b) so a sky lookup is a single device-memory gather +
shifts instead of three channel gathers. Float cubemaps (procedural skies)
keep three channel planes. 1x1 cubemaps (constant/per-face colors) skip
the gather entirely via a 6-way select.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ray_tracing_tpu.ops.vec import Vec3

# Face order: src/gpu_and_windowing.h:8-15
CF_FRONT, CF_BACK, CF_LEFT, CF_RIGHT, CF_TOP, CF_BOTTOM = 0, 1, 2, 3, 4, 5


@dataclasses.dataclass(frozen=True)
class CubemapData:
    """Pytree. Exactly one storage is populated (None is pytree-empty, so
    which-storage is static structure):

    packed: (6*H*W,) uint32 0x00RRGGBB — 8-bit cubemaps (one-gather path)
    r/g/b:  (6*H*W,) float32 planes   — float cubemaps
    """

    packed: jax.Array | None
    r: jax.Array | None
    g: jax.Array | None
    b: jax.Array | None
    h: int
    w: int

    @staticmethod
    def from_faces(faces) -> "CubemapData":
        """faces: (6, H, W, 3) uint8 (packed path) or float (channel path)."""
        import numpy as np

        f = np.asarray(faces)
        if f.ndim != 4 or f.shape[0] != 6 or f.shape[3] != 3:
            # a single (H, W, 3) face would silently become h=W, w=3
            raise ValueError(f"expected (6, H, W, 3) faces, got {f.shape}")
        if f.dtype != np.uint8 and np.issubdtype(f.dtype, np.integer):
            raise ValueError(
                f"integer faces must be uint8 (got {f.dtype}); convert or "
                "pass float radiance"
            )
        h, w = f.shape[1], f.shape[2]
        flat = f.reshape(-1, 3)
        if f.dtype == np.uint8:
            packed = (
                (flat[:, 0].astype(np.uint32) << 16)
                | (flat[:, 1].astype(np.uint32) << 8)
                | flat[:, 2].astype(np.uint32)
            )
            return CubemapData(packed=jnp.asarray(packed), r=None, g=None, b=None, h=h, w=w)
        flat = flat.astype(np.float32)
        return CubemapData(
            packed=None,
            r=jnp.asarray(flat[:, 0]),
            g=jnp.asarray(flat[:, 1]),
            b=jnp.asarray(flat[:, 2]),
            h=h,
            w=w,
        )


jax.tree_util.register_dataclass(
    CubemapData, data_fields=["packed", "r", "g", "b"], meta_fields=["h", "w"]
)


def face_uv(d: Vec3):
    """Unit directions -> (face:int32, u, v) per the reference tables
    (src/gpu_and_windowing.c:54-94). u, v in [-1, 1] pre-clamp."""
    ax, ay, az = jnp.abs(d.x), jnp.abs(d.y), jnp.abs(d.z)

    x_dom = (ax > ay) & (ax > az)
    y_dom = (ay > ax) & (ay > az)  # else: Z dominant (ties fall to Z)

    sx = jnp.where(ax > 0, ax, 1.0)
    sy = jnp.where(ay > 0, ay, 1.0)
    sz = jnp.where(az > 0, az, 1.0)

    # The X/Y branches require strict dominance, so their divisors are
    # nonzero; the Z FALLBACK can be selected with az == 0 (exact
    # |x| == |y| ties, e.g. a 45-degree specular direction). There the
    # reference divides by 0 -> +-inf and the caller's clamp lands on the
    # EDGE texel; dividing by the sz=1 guard instead would land on an
    # interior texel. Saturate those lanes past the clamp range with the
    # numerator's sign (gradient-free — sign() has zero vjp — so no
    # inf partials).
    z0 = az == 0.0
    uz_num = jnp.where(d.z > 0, d.x, -d.x)
    vz_num = -d.y
    u_z = jnp.where(z0, jnp.sign(uz_num) * 4.0, uz_num / sz)
    v_z = jnp.where(z0, jnp.sign(vz_num) * 4.0, vz_num / sz)

    u = jnp.where(
        x_dom,
        jnp.where(d.x > 0, -d.z, d.z) / sx,
        jnp.where(y_dom, d.x / sy, u_z),
    )
    v = jnp.where(
        x_dom,
        -d.y / sx,
        jnp.where(y_dom, jnp.where(d.y > 0, d.z, -d.z) / sy, v_z),
    )
    face = jnp.where(
        x_dom,
        jnp.where(d.x > 0, CF_RIGHT, CF_LEFT),
        jnp.where(
            y_dom,
            jnp.where(d.y > 0, CF_TOP, CF_BOTTOM),
            jnp.where(d.z > 0, CF_FRONT, CF_BACK),
        ),
    ).astype(jnp.int32)
    return face, u, v


def _unpack(t) -> Vec3:
    s = 1.0 / 255.0
    return Vec3(
        ((t >> 16) & 0xFF).astype(jnp.float32) * s,
        ((t >> 8) & 0xFF).astype(jnp.float32) * s,
        (t & 0xFF).astype(jnp.float32) * s,
    )


def _fetch_flat(cubemap: CubemapData, flat) -> Vec3:
    """Texel fetch at flat indices: one gather (packed) or three (float)."""
    if cubemap.packed is not None:
        return _unpack(jnp.take(cubemap.packed, flat))
    return Vec3(
        jnp.take(cubemap.r, flat),
        jnp.take(cubemap.g, flat),
        jnp.take(cubemap.b, flat),
    )


def _fetch(cubemap: CubemapData, face, y, x) -> Vec3:
    """Texel fetch at integer coords; 1x1 cubemaps use a gather-free 6-way
    select."""
    if cubemap.h == 1 and cubemap.w == 1:
        if cubemap.packed is not None:
            texels = [_unpack(cubemap.packed[k]) for k in range(6)]
        else:
            texels = [Vec3(cubemap.r[k], cubemap.g[k], cubemap.b[k]) for k in range(6)]
        out = texels[5]
        for k in range(4, -1, -1):
            out = Vec3.where(face == k, texels[k].broadcast_to(face.shape), out)
        return out

    return _fetch_flat(cubemap, _flat_index(cubemap, face, y, x))


def _flat_index(cubemap: CubemapData, face, y, x):
    """(face, y, x) -> flat texel index: the ONE copy of the packed
    layout arithmetic — _fetch gathers with it and texel_flat_index keys
    the sparse sky cache on it; a drifted copy would silently desync
    cache reuse from the actual fetches."""
    return (face * cubemap.h + y) * cubemap.w + x


def _face_texel_f(cubemap: CubemapData, d: Vec3):
    """(face, fy, fx): clamp uv to [-1,1], remap to [0,1], scale to float
    texel coords — shared by the nearest truncation and the bilinear
    floor/lerp (src/gpu_and_windowing.c:96-111)."""
    face, u, v = face_uv(d)
    u = 0.5 * (jnp.clip(u, -1.0, 1.0) + 1.0)
    v = 0.5 * (jnp.clip(v, -1.0, 1.0) + 1.0)
    return face, v * (cubemap.h - 1), u * (cubemap.w - 1)


def sample_cubemap(cubemap: CubemapData, d: Vec3, bilinear: bool = False) -> Vec3:
    """Skybox lookup for unit directions -> RGB in [0,1].

    bilinear=False matches src/gpu_and_windowing.c:96-111 exactly: clamp uv
    to [-1,1], remap to [0,1], truncate to texel coords, bytes/255.

    bilinear=True is the differentiable-mode filter (no reference analogue):
    a 4-texel lerp inside the face, so radiance is piecewise-smooth in the
    ray direction and gradients flow from the sky to geometry/camera/
    roughness. Face choice and texel indices stay detached (standard
    texture-filter autodiff semantics).
    """
    if not bilinear:
        if cubemap.h == 1 and cubemap.w == 1:
            face, _, _ = face_uv(d)
            return _fetch(cubemap, face, 0, 0)
        # the SAME flat-index math the sparse sky cache keys on — a single
        # helper keeps cache reuse exact by construction
        return _fetch_flat(cubemap, texel_flat_index(cubemap, d))

    if cubemap.h == 1 and cubemap.w == 1:
        # degenerate lerp (all four corners are the one texel): take the
        # gather-free select instead of four redundant fetch chains
        face, _, _ = face_uv(d)
        return _fetch(cubemap, face, 0, 0)

    face, fy, fx = _face_texel_f(cubemap, d)
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, cubemap.w - 1)
    y1 = jnp.minimum(y0 + 1, cubemap.h - 1)
    wx = fx - x0  # gradient flows through these weights
    wy = fy - y0

    c00 = _fetch(cubemap, face, y0, x0)
    c01 = _fetch(cubemap, face, y0, x1)
    c10 = _fetch(cubemap, face, y1, x0)
    c11 = _fetch(cubemap, face, y1, x1)
    top = c00 + (c01 - c00) * wx
    bot = c10 + (c11 - c10) * wx
    return top + (bot - top) * wy


def texel_flat_index(cubemap: CubemapData, d: Vec3):
    """Flat texel index of the nearest-texel lookup for unit directions —
    the same (face, y, x) -> flat map _fetch gathers with. Pure elementwise math
    (no gather); lets callers dedupe/compact sky lookups by index."""
    face, fy, fx = _face_texel_f(cubemap, d)
    x = fx.astype(jnp.int32)
    y = fy.astype(jnp.int32)
    return _flat_index(cubemap, face, y, x)


def unpack_texels(packed) -> Vec3:
    """uint32 0x00RRGGBB texels -> RGB Vec3 in [0, 1]."""
    return _unpack(packed)


SPARSE_BLOCK = 128  # the megakernel's padded planes always divide


def sparse_sky_lookup(
    cubemap: CubemapData,
    flat,
    need,
    cache_flat=None,
    cache_packed=None,
    cache_valid=None,
    budget: int | None = None,
):
    """EXACT nearest-texel lookup for `need` pixels, cost-compacted.

    A whole-frame skybox gather reads 2M random texels of a table larger
    than the cache. But across Monte-Carlo samples at a fixed camera,
    most sky lookups repeat: primary misses (no pixel jitter => same
    direction every sample) and pure-specular chains produce the SAME flat
    index each sample. This helper gathers only indices that changed:

      reuse:  cache_valid & (flat == cache_flat)  -> cached texel. Equality
              of the flat index implies equality of the texel, so reuse is
              exact by construction, not an approximation.
      fresh:  BLOCK-compacted gather — per-128-pixel-block "any fresh"
              flags compacted by an exclusive cumsum + one scatter (the
              semantics of jnp.nonzero(size=…, fill_value=nb)), then
              1-D gathers/scatter over the
              selected blocks' pixels. Fresh pixels cluster spatially
              (object silhouettes), so block granularity over-gathers only
              ~2x. Two static budget tiers + full-gather fallback via
              lax.cond: exactness never depends on the budget guess, the
              budget only caps the compacted pipelines' static cost.

    Returns a uint32 texel plane (zeros where ~need). Only valid for
    packed (8-bit) cubemaps.
    """
    assert cubemap.packed is not None, "sparse lookup needs a packed cubemap"
    size = flat.size
    shape = flat.shape
    flat = flat.ravel()
    need = need.ravel()

    if cache_flat is None:
        reuse = jnp.zeros_like(need)
        cache_packed = jnp.uint32(0)
    else:
        reuse = cache_valid.ravel() & (flat == cache_flat.ravel())
    fresh_need = need & ~reuse

    def full(_):
        return jnp.where(fresh_need, jnp.take(cubemap.packed, flat), jnp.uint32(0))

    if size % SPARSE_BLOCK:
        fresh = full(None)
    else:
        nb = size // SPARSE_BLOCK
        fb = jnp.any(fresh_need.reshape(nb, SPARSE_BLOCK), axis=1)
        count = jnp.sum(fb)
        if budget is None:
            budget = max(nb // 8, 256)
        tiers = sorted({max(min(budget // 4, nb), 1), max(min(budget, nb), 1)})

        def compacted(bb):
            def run(_):
                # equivalent of jnp.nonzero(fb, size=bb, fill_value=nb)[0]
                # — first bb true block ids ascending, nb-padded — via an
                # exclusive cumsum + one scatter
                fbi = fb.astype(jnp.int32)
                slot = jnp.cumsum(fbi) - fbi  # exclusive prefix: write slot
                pos_b = (
                    jnp.full((bb,), nb, jnp.int32)
                    .at[jnp.where(fb, slot, bb)]
                    .set(jnp.arange(nb, dtype=jnp.int32), mode="drop")
                )
                pos = (
                    pos_b[:, None] * SPARSE_BLOCK
                    + jax.lax.broadcasted_iota(jnp.int32, (bb, SPARSE_BLOCK), 1)
                ).ravel()
                fl = jnp.take(flat, pos, mode="clip")
                tex = jnp.take(cubemap.packed, fl)
                return (
                    jnp.zeros((size,), jnp.uint32).at[pos].set(tex, mode="drop")
                )
            return run

        fresh = jax.lax.cond(
            count <= tiers[0],
            compacted(tiers[0]),
            lambda _: jax.lax.cond(
                count <= tiers[-1], compacted(tiers[-1]), full, None
            ),
            None,
        )

    out = jnp.where(need, jnp.where(reuse, cache_packed if jnp.ndim(cache_packed) == 0 else cache_packed.ravel(), fresh), jnp.uint32(0))
    return out.reshape(shape)


def downsample_packed(cubemap: CubemapData, factor: int) -> CubemapData:
    """Nearest-decimated packed cubemap: the SAME uint32 one-gather code
    path as the full skybox over a table factor^2 smaller. For dryruns and
    CPU tests that must exercise real texel-index gathers (the reference
    always renders its 2048^2 skybox, src/main.c:500-508) without paying
    for 25M texels on a virtual mesh."""
    assert cubemap.packed is not None, "downsample_packed needs a packed cubemap"
    h, w = cubemap.h, cubemap.w
    faces = cubemap.packed.reshape(6, h, w)
    dec = faces[:, ::factor, ::factor]
    # metadata MUST come from the sliced shape: ::factor keeps
    # ceil(h/factor) rows, and declaring floor (h//factor) when factor
    # does not divide h would desynchronize texel_flat_index's
    # (face*h+y)*w+x arithmetic from the packed layout — every in-bounds
    # gather silently lands on the wrong row
    h2, w2 = int(dec.shape[1]), int(dec.shape[2])
    return CubemapData(
        packed=dec.reshape(-1), r=None, g=None, b=None, h=h2, w=w2,
    )


def checker_sky(size: int = 64) -> CubemapData:
    """Deterministic synthetic PACKED-uint32 cubemap (face-tinted
    checkerboard): a stand-in for the JPEG skybox wherever the 8-bit
    one-gather path must run but the reference assets are absent."""
    import numpy as np

    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    check = ((yy // 4 + xx // 4) % 2).astype(np.int32)
    faces = np.zeros((6, size, size, 3), np.uint8)
    for f in range(6):
        # int32 arithmetic + clip: uint8 math would wrap (40*5+55+120 =
        # 375 -> 119) and invert the checker highlight on faces 3-5
        faces[f, ..., 0] = np.clip(40 * f + 55 + 120 * check, 0, 255)
        faces[f, ..., 1] = np.clip(255 - 30 * f - 100 * check, 0, 255)
        faces[f, ..., 2] = (xx * 255) // max(size - 1, 1)
    return CubemapData.from_faces(faces)


def noise_sky(size: int = 2048, seed: int = 0) -> CubemapData:
    """Seeded PACKED-uint32 cubemap with real texel entropy: per-face
    colour ramps plus 6 bits of random noise per channel, built on the
    device. At size 2048 the table is 6*2048^2*4 B = 100.7 MB, the size of
    the reference's JPEG skybox, so sky lookups miss in cache as they
    would with the real asset."""
    n = 6 * size * size

    @jax.jit
    def build(key):
        idx = jnp.arange(n, dtype=jnp.uint32)
        face = idx // (size * size)
        y = (idx // size) % size
        x = idx % size
        # every channel stays <= 192 before its <= 63 of noise
        r = 30 + 16 * face + (x * 80) // size
        g = 60 + (y * 120) // size
        b = 190 - 10 * face
        noise = jax.random.bits(key, (n,), jnp.uint32) & jnp.uint32(0x3F3F3F)
        return ((r << 16) | (g << 8) | b) + noise

    packed = build(jax.random.key(seed))
    return CubemapData(packed=packed, r=None, g=None, b=None, h=size, w=size)


def constant_sky(color=(0.0, 0.0, 0.0)) -> CubemapData:
    """1x1 uniform-color cubemap — the 'no skybox' mode the reference shows
    only as commented-out code (src/main.c:166-169). Gather-free sampling."""
    import numpy as np

    c = np.broadcast_to(np.asarray(color, np.float32), (6, 1, 1, 3)).copy()
    return CubemapData.from_faces(c)


def gradient_sky(size: int = 32) -> CubemapData:
    """Smooth synthetic sky with per-face linear ramps. Radiance varies with
    direction, so (with env_filter="bilinear") geometry/camera gradients are
    non-degenerate — the right default for inverse rendering when no real
    skybox is loaded (a constant sky makes position gradients exactly zero)."""
    import numpy as np

    yy, xx = np.meshgrid(
        np.linspace(0.0, 1.0, size), np.linspace(0.0, 1.0, size), indexing="ij"
    )
    faces = np.zeros((6, size, size, 3), np.float32)
    for f in range(6):
        faces[f, ..., 0] = 0.15 + 0.7 * xx * ((f % 3) + 1) / 3
        faces[f, ..., 1] = 0.2 + 0.6 * yy
        faces[f, ..., 2] = 0.25 + 0.1 * f + 0.4 * xx * (1 - yy)
    return CubemapData.from_faces(faces)
