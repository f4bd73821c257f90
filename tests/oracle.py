"""Scalar numpy oracle implementing the reference semantics directly.

Hand-written from the behavioral description in SURVEY.md (not copied
code): quadratic sphere solve (src/scene.c:79-134), slab AABB with axis
normals (src/scene.c:17-77), closest-hit scan (src/scene.c:156-190),
cubemap face/uv/nearest rules (src/gpu_and_windowing.c:42-112), camera ray
(src/camera.c:95-125). Used to cross-check the vectorized JAX ops on random
inputs.
"""

import math

import numpy as np


def normalize(v, eps=1e-5):
    n = np.linalg.norm(v)
    if n < eps:
        return v
    return v / n


def sphere_t(ro, rd, center, radius):
    """Returns t >= 0 or None. rd assumed normalized by the caller."""
    oc = center - ro
    a = float(np.dot(rd, rd))
    b = -2.0 * float(np.dot(oc, rd))
    c = float(np.dot(oc, oc)) - radius * radius
    discr = b * b - 4 * a * c
    if discr <= 0:
        return None
    sq = math.sqrt(discr)
    s0 = (-b - sq) / (2 * a)
    s1 = (-b + sq) / (2 * a)
    if s0 > s1:
        s0, s1 = s1, s0
    if s0 < 0:
        s0 = s1
        if s0 < 0:
            return None
    return s0


def cube_t_normal(ro, rd, lo, size):
    """Returns (tnear, normal) or None, with the reference's axis tracking.
    tnear may be negative (caller applies the t >= 0 filter like trace_ray)."""
    hi = lo + size
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lo = (lo - ro) / rd
        t_hi = (hi - ro) / rd
    tmin = np.where(rd >= 0, t_lo, t_hi)
    tmax = np.where(rd >= 0, t_hi, t_lo)

    hit_axis = 0
    txmin, txmax = tmin[0], tmax[0]
    if txmin > tmax[1] or tmin[1] > txmax:
        return None
    if tmin[1] > txmin:
        txmin = tmin[1]
        hit_axis = 1
    if tmax[1] < txmax:
        txmax = tmax[1]
    if txmin > tmax[2] or tmin[2] > txmax:
        return None
    if tmin[2] > txmin:
        txmin = tmin[2]
        hit_axis = 2

    normal = np.zeros(3)
    normal[hit_axis] = -1.0 if rd[hit_axis] > 0 else 1.0
    return txmin, normal


def trace(objects, ro, rd):
    """objects: list of dicts {kind, p0, p1}. Returns (t, index, normal) or
    (None, -1, None). Mirrors trace_ray's strict-< first-wins scan."""
    rd = normalize(np.asarray(rd, np.float64))
    ro = np.asarray(ro, np.float64)
    nearest_t = float("inf")
    nearest_i = -1
    nearest_n = None
    for i, o in enumerate(objects):
        if o["kind"] == "sphere":
            t = sphere_t(ro, rd, np.asarray(o["p0"]), o["p1"][0])
            n = None
            if t is not None:
                p = ro + rd * t
                n = normalize(p - np.asarray(o["p0"]))
        else:
            r = cube_t_normal(ro, rd, np.asarray(o["p0"]), np.asarray(o["p1"]))
            if r is None:
                t = None
            else:
                t, n = r
        if t is None:
            continue
        if t >= 0 and t < nearest_t:
            nearest_t, nearest_i, nearest_n = t, i, n
    if nearest_i == -1:
        return None, -1, None
    return nearest_t, nearest_i, nearest_n


# Face ids match ray_tracing_tpu.ops.cubemap / src/gpu_and_windowing.h
CF_FRONT, CF_BACK, CF_LEFT, CF_RIGHT, CF_TOP, CF_BOTTOM = 0, 1, 2, 3, 4, 5


def cubemap_face_uv(d):
    ax, ay, az = abs(d[0]), abs(d[1]), abs(d[2])
    if ax > ay and ax > az:
        if d[0] > 0:
            return CF_RIGHT, -d[2] / ax, -d[1] / ax
        return CF_LEFT, d[2] / ax, -d[1] / ax
    if ay > ax and ay > az:
        if d[1] > 0:
            return CF_TOP, d[0] / ay, d[2] / ay
        return CF_BOTTOM, d[0] / ay, -d[2] / ay
    if d[2] > 0:
        return CF_FRONT, d[0] / az, -d[1] / az
    return CF_BACK, -d[0] / az, -d[1] / az


def cubemap_sample(faces_u8, d):
    """faces_u8: (6, H, W, 3) uint8 -> [0,1] rgb."""
    face, u, v = cubemap_face_uv(d)
    u = min(max(u, -1.0), 1.0)
    v = min(max(v, -1.0), 1.0)
    u = 0.5 * (u + 1)
    v = 0.5 * (v + 1)
    h, w = faces_u8.shape[1], faces_u8.shape[2]
    x = int(u * (w - 1))
    y = int(v * (h - 1))
    return faces_u8[face, y, x].astype(np.float64) / 255.0


def camera_ray(pos, front, up, u, v, aspect, fov_deg=30.0, degrees_bug=True):
    """src/camera.c:95-125 including the tan(degrees) quirk."""
    pos = np.asarray(pos, np.float64)
    w = normalize(-np.asarray(front, np.float64))
    ub = normalize(np.cross(np.asarray(up, np.float64), w))
    vb = np.cross(w, ub)
    half = fov_deg / 2.0 if degrees_bug else math.radians(fov_deg / 2.0)
    sh = 2.0 * math.tan(half)
    sw = aspect * sh
    horizontal = ub * sw
    vertical = vb * sh
    llc = pos - 0.5 * horizontal - 0.5 * vertical - w
    rd = llc + u * horizontal + v * vertical - pos
    return pos, rd
