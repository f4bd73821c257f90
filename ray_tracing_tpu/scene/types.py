"""Scene data model as a JAX pytree (struct-of-arrays, static topology).

The reference stores an array-of-structs ``Object objects[1024]`` with a
tagged union of Sphere/Cube plus a Material (src/scene.h:5-43). The
device scene is the transpose: one array per field, so intersection
tests vectorize over pixels with the object loop unrolled — and the object
*kinds* are static pytree metadata, so jit specializes the closest-hit loop
per topology (sphere code for spheres, AABB code for cubes, no runtime tag
dispatch at all). Continuous parameters (geometry + materials) are traced,
differentiable leaves.

Geometry is unified: ``p0``/``p1`` mean (center, {radius,_,_}) for spheres
and (origin, size) for cubes, selected by the static ``obj_type`` tag.

Design deltas vs the reference, on purpose:

* No padding slots — shapes are (num_objects, ...) and a new scene topology
  simply retraces (scenes are tiny and loaded once; MAX_OBJECTS=1024 is
  enforced by the parser, src/scene.h:3).
* The next-event-estimation light is chosen statically at scene build time
  (first object with emission_power > 0) — the reference re-scans per pixel
  (src/main.c:140-146) but with identical result for any fixed scene.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracing_tpu.ops.vec import Vec3

OBJ_NONE = 0
OBJ_SPHERE = 1
OBJ_CUBE = 2


def light_origin_from(p0: Vec3, p1: Vec3, is_sphere: bool) -> Vec3:
    """Object 'origin' for NEE light sampling — sphere center, or cube
    origin + size/2 (src/scene.c:10-15). The ONE formula every tracer's
    light_origin flows through: the recording forward and the
    differentiable replay must agree bit-exactly for NEE gradient
    routing, so keep Scene.origin_of, SceneView.origin_of and the
    replay/fetch tracers (kernels/megakernel.py) on this helper."""
    if is_sphere:
        return p0
    return p0 + p1 * 0.5

# Material defaults from the reference parser (src/scene.c:232-254).
DEFAULT_ALBEDO = (0.44, 0.68, 0.84)
DEFAULT_ROUGHNESS = 0.0
DEFAULT_REFLECTANCE = 0.2
DEFAULT_METALLIC = 0.0
DEFAULT_EMISSION_POWER = 0.0
DEFAULT_EMISSION_COLOR = (1.0, 1.0, 1.0)
DEFAULT_SPHERE_CENTER = (0.0, 0.0, 0.0)
DEFAULT_SPHERE_RADIUS = 1.0
DEFAULT_CUBE_ORIGIN = (0.0, 0.0, 0.0)
DEFAULT_CUBE_SIZE = (1.0, 1.0, 1.0)


@dataclasses.dataclass
class ObjectSpec:
    """Host-side description of one object, produced by the parser."""

    kind: str  # "sphere" | "cube"
    p0: tuple = DEFAULT_SPHERE_CENTER           # center / origin
    p1: tuple = (DEFAULT_SPHERE_RADIUS,) * 3    # (radius,)*3 / size
    albedo: tuple = DEFAULT_ALBEDO
    roughness: float = DEFAULT_ROUGHNESS
    reflectance: float = DEFAULT_REFLECTANCE
    metallic: float = DEFAULT_METALLIC
    emission_power: float = DEFAULT_EMISSION_POWER
    emission_color: tuple = DEFAULT_EMISSION_COLOR


@dataclasses.dataclass(frozen=True)
class Scene:
    """Struct-of-arrays scene; leading dim of every leaf = num_objects.

    Data leaves (differentiable): p0, p1, albedo, roughness, reflectance,
    metallic, emission_power, emission_color.
    Static metadata: obj_type (tuple of OBJ_* ints), light_index, emissive.
    """

    obj_type: tuple            # static: per-object OBJ_SPHERE / OBJ_CUBE
    light_index: int           # static: first emissive object, -1 if none
    p0: jax.Array              # (N, 3) f32: sphere center / cube origin
    p1: jax.Array              # (N, 3) f32: (radius,)*3 / cube size
    albedo: jax.Array          # (N, 3) f32
    roughness: jax.Array       # (N,) f32
    reflectance: jax.Array     # (N,) f32
    metallic: jax.Array        # (N,) f32
    emission_power: jax.Array  # (N,) f32
    emission_color: jax.Array  # (N, 3) f32
    # static per-object emission_power > 0 at BUILD time; enables the
    # occlusion-only shadow trace (ops/intersect._trace_shadow_occlusion)
    # when exactly one object is emissive. None = unknown -> full scan;
    # replace(scene, emissive=None) restores exact NEE gradient routing to
    # every object's emission (see trace_shadow's docstring).
    emissive: tuple | None = None

    @property
    def num_objects(self) -> int:
        return len(self.obj_type)

    @property
    def has_light(self) -> bool:
        return self.light_index >= 0

    def is_sphere(self, i: int) -> bool:
        return self.obj_type[i] == OBJ_SPHERE

    def radius(self, i: int):
        return self.p1[i, 0]

    def center(self, i: int) -> Vec3:
        return Vec3(self.p0[i, 0], self.p0[i, 1], self.p0[i, 2])

    def box_lo(self, i: int) -> Vec3:
        return Vec3(self.p0[i, 0], self.p0[i, 1], self.p0[i, 2])

    def box_hi(self, i: int) -> Vec3:
        return Vec3(
            self.p0[i, 0] + self.p1[i, 0],
            self.p0[i, 1] + self.p1[i, 1],
            self.p0[i, 2] + self.p1[i, 2],
        )

    def albedo_of(self, i: int) -> Vec3:
        return Vec3(self.albedo[i, 0], self.albedo[i, 1], self.albedo[i, 2])

    def roughness_of(self, i: int):
        return self.roughness[i]

    def reflectance_of(self, i: int):
        return self.reflectance[i]

    def metallic_of(self, i: int):
        return self.metallic[i]

    def emission_of(self, i: int) -> Vec3:
        """emission_color * emission_power for object i (src/main.c:203,232)."""
        p = self.emission_power[i]
        return Vec3(
            self.emission_color[i, 0] * p,
            self.emission_color[i, 1] * p,
            self.emission_color[i, 2] * p,
        )

    def origin_of(self, i: int) -> Vec3:
        """Object 'origin' for light sampling (light_origin_from)."""
        return light_origin_from(
            self.center(i),
            Vec3(self.p1[i, 0], self.p1[i, 1], self.p1[i, 2]),
            self.is_sphere(i),
        )

    def packed_rows(self) -> jax.Array:
        """(N, 16) packed parameter rows for the scan-based large-scene
        trace (ops/intersect.py): p0 | p1 | albedo | roughness | reflectance
        | metallic | emission_color*power | type tag."""
        emission = self.emission_color * self.emission_power[:, None]
        tag = jnp.asarray(self.obj_type, jnp.float32)[:, None]
        return jnp.concatenate(
            [
                self.p0,
                self.p1,
                self.albedo,
                self.roughness[:, None],
                self.reflectance[:, None],
                self.metallic[:, None],
                emission,
                tag,
            ],
            axis=1,
        ).astype(jnp.float32)

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_objects(objects: list[ObjectSpec]) -> "Scene":
        """Pack host-side ObjectSpecs into the SoA pytree."""
        n = len(objects)
        obj_type = tuple(
            OBJ_SPHERE if o.kind == "sphere" else OBJ_CUBE for o in objects
        )
        # Reference light selection: FIRST object with emission_power > 0
        # (src/main.c:140-146), frozen at build time.
        light_index = -1
        for i, o in enumerate(objects):
            if o.emission_power > 0:
                light_index = i
                break

        def field(fn, shape):
            out = np.zeros((n, *shape), np.float32)
            for i, o in enumerate(objects):
                out[i] = fn(o)
            return jnp.asarray(out)

        return Scene(
            obj_type=obj_type,
            light_index=light_index,
            emissive=tuple(o.emission_power > 0 for o in objects),
            p0=field(lambda o: o.p0, (3,)),
            p1=field(lambda o: o.p1, (3,)),
            albedo=field(lambda o: o.albedo, (3,)),
            roughness=field(lambda o: o.roughness, ()),
            reflectance=field(lambda o: o.reflectance, ()),
            metallic=field(lambda o: o.metallic, ()),
            emission_power=field(lambda o: o.emission_power, ()),
            emission_color=field(lambda o: o.emission_color, (3,)),
        )

    def to_objects(self) -> list[ObjectSpec]:
        """Inverse of from_objects. Host-side / numpy."""
        host = {
            f.name: np.asarray(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name not in ("obj_type", "light_index", "emissive")
        }
        out = []
        for i in range(self.num_objects):
            out.append(
                ObjectSpec(
                    kind="sphere" if self.obj_type[i] == OBJ_SPHERE else "cube",
                    p0=tuple(host["p0"][i].tolist()),
                    p1=tuple(host["p1"][i].tolist()),
                    albedo=tuple(host["albedo"][i].tolist()),
                    roughness=float(host["roughness"][i]),
                    reflectance=float(host["reflectance"][i]),
                    metallic=float(host["metallic"][i]),
                    emission_power=float(host["emission_power"][i]),
                    emission_color=tuple(host["emission_color"][i].tolist()),
                )
            )
        return out


jax.tree_util.register_dataclass(
    Scene,
    data_fields=[
        "p0",
        "p1",
        "albedo",
        "roughness",
        "reflectance",
        "metallic",
        "emission_power",
        "emission_color",
    ],
    meta_fields=["obj_type", "light_index", "emissive"],
)


def random_scene(num: int, seed: int = 0, light: int = 7) -> Scene:
    """Seeded synthetic scene of `num` objects in [-6, 6]^3: every third a
    cube, the rest spheres, object `light` (if < num) the one emitter.
    Sizes past ops/intersect.UNROLL_LIMIT exercise the packed-row trace."""
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(num):
        if i % 3 == 0:
            objs.append(ObjectSpec(
                kind="cube", p0=tuple(rng.uniform(-6, 6, 3)),
                p1=tuple(rng.uniform(0.5, 2.0, 3)),
                albedo=tuple(rng.uniform(0.2, 1, 3)),
                roughness=float(rng.uniform())))
        else:
            objs.append(ObjectSpec(
                kind="sphere", p0=tuple(rng.uniform(-6, 6, 3)),
                p1=(float(rng.uniform(0.4, 1.2)),) * 3,
                albedo=tuple(rng.uniform(0.2, 1, 3)),
                roughness=float(rng.uniform()),
                reflectance=float(rng.uniform()),
                emission_power=2.0 if i == light else 0.0))
    return Scene.from_objects(objs)
