"""Parser tests vs the reference grammar (src/scene.c:206-609, SURVEY.md §3.4)."""

import numpy as np
import pytest

from ray_tracing_tpu.scene.parser import (
    MAX_OBJECTS,
    SceneParseError,
    parse_objects,
    parse_scene_string,
)
from ray_tracing_tpu.scene.types import OBJ_CUBE, OBJ_SPHERE, Scene


def test_defaults_sphere():
    (o,) = parse_objects("sphere")
    assert o.kind == "sphere"
    assert o.p0 == (0, 0, 0)
    assert o.p1 == (1, 1, 1)
    assert o.albedo == (0.44, 0.68, 0.84)
    assert o.roughness == 0
    assert o.reflectance == 0.2
    assert o.metallic == 0
    assert o.emission_power == 0
    assert o.emission_color == (1, 1, 1)


def test_defaults_cube():
    (o,) = parse_objects("cube")
    assert o.kind == "cube"
    assert o.p0 == (0, 0, 0)
    assert o.p1 == (1, 1, 1)


def test_properties_and_vectors():
    (o,) = parse_objects(
        "sphere\n\tradius 2.5\n\tcenter {1 -2 3.25}\n\talbedo   {0.1 0.2 0.3}\n"
        "\troughness 0.5 reflectance 1 metallic   0.25\n"
        "\temission_power 5 emission_color {0 1 0.5}\n"
    )
    assert o.p1 == (2.5, 2.5, 2.5)
    assert o.p0 == (1, -2, 3.25)
    assert o.albedo == (0.1, 0.2, 0.3)
    assert o.roughness == 0.5
    assert o.reflectance == 1
    assert o.metallic == 0.25
    assert o.emission_power == 5
    assert o.emission_color == (0, 1, 0.5)


def test_albedo_metallic_skip_quirk():
    # The reference eats up to 3 extra whitespace chars after these names
    # (src/scene.c:280,320); with >=3 spaces both parsers agree.
    (o,) = parse_objects("sphere albedo    {0 0 1} metallic    1")
    assert o.albedo == (0, 0, 1)
    assert o.metallic == 1


def test_kind_checked_properties():
    with pytest.raises(SceneParseError, match="radius"):
        parse_objects("cube radius 1")
    with pytest.raises(SceneParseError, match="center"):
        parse_objects("cube center {0 0 0}")
    with pytest.raises(SceneParseError, match="origin"):
        parse_objects("sphere origin {0 0 0}")
    with pytest.raises(SceneParseError, match="size"):
        parse_objects("sphere size {1 1 1}")


def test_range_validation():
    with pytest.raises(SceneParseError, match="albedo"):
        parse_objects("sphere albedo    {2 0 0}")
    with pytest.raises(SceneParseError, match="Roughness"):
        parse_objects("sphere roughness 1.5")
    with pytest.raises(SceneParseError, match="Reflectance"):
        parse_objects("sphere reflectance -0.1")
    with pytest.raises(SceneParseError, match="Metallic"):
        parse_objects("sphere metallic    2")
    with pytest.raises(SceneParseError, match="Size"):
        parse_objects("cube size {-1 1 1}")
    # emission_power is NOT range checked (src/scene.c:566-568)
    parse_objects("sphere emission_power 100")


def test_number_grammar():
    (o,) = parse_objects("sphere radius 10")
    assert o.p1[0] == 10
    (o,) = parse_objects("sphere radius 0.125")
    assert o.p1[0] == 0.125
    (o,) = parse_objects("sphere emission_power -3.5")
    assert o.emission_power == -3.5
    # no exponents / leading dots / plus signs (src/scene.c:427-461)
    with pytest.raises(SceneParseError):
        parse_objects("sphere radius .5")
    with pytest.raises(SceneParseError):
        parse_objects("sphere radius 1.")
    with pytest.raises(SceneParseError):
        parse_objects("sphere radius -")


def test_error_line_numbers():
    with pytest.raises(SceneParseError) as e:
        parse_objects("sphere\n\nbogus")
    assert e.value.line == 3


def test_invalid_keyword():
    with pytest.raises(SceneParseError, match="Invalid character"):
        parse_objects("pyramid")


def test_max_objects_dropped():
    warnings = []
    src = "sphere\n" * (MAX_OBJECTS + 3)
    objs = parse_objects(src, warn=warnings.append)
    assert len(objs) == MAX_OBJECTS
    assert len(warnings) == 3


def test_reference_scenes_parse(scene0_text, scene1_text, scene2_text):
    # Scene sizes per SURVEY.md §6: 9, 7, 3 objects.
    o0 = parse_objects(scene0_text)
    o1 = parse_objects(scene1_text)
    o2 = parse_objects(scene2_text)
    assert len(o0) == 9
    assert [o.kind for o in o0] == ["cube"] * 6 + ["sphere"] * 3
    assert len(o1) == 7
    assert len(o2) == 3
    assert all(o.kind == "sphere" for o in o2)
    # scene_0's light: sphere at {3 5 3}, power 5 (scene_0.txt last object)
    assert o0[8].emission_power == 5
    assert o0[8].p0 == (3, 5, 3)


def test_scene_pytree_roundtrip(scene0_text):
    scene = parse_scene_string(scene0_text)
    assert scene.num_objects == 9
    assert scene.obj_type[0] == OBJ_CUBE
    assert scene.obj_type[8] == OBJ_SPHERE
    # light = first emissive object (src/main.c:140-146), frozen at build
    assert scene.has_light
    assert scene.light_index == 8
    # origin_of: cube center = origin + size/2 (src/scene.c:10-15)
    o = scene.origin_of(0)
    np.testing.assert_allclose(
        [float(o.x), float(o.y), float(o.z)], [1.5, 2.5, 0.05], rtol=1e-6
    )
    # round trip
    objs = scene.to_objects()
    assert len(objs) == 9
    assert objs[8].emission_power == 5


def test_scene_is_pytree(scene2_text):
    import jax

    scene = parse_scene_string(scene2_text)
    leaves = jax.tree_util.tree_leaves(scene)
    assert len(leaves) == 8  # 8 data fields; obj_type/light_index are static
    scene2 = jax.tree_util.tree_map(lambda x: x, scene)
    assert scene2.obj_type == scene.obj_type
    assert scene2.light_index == scene.light_index
    # static topology means Scene works as a jit argument with retrace-per-
    # topology semantics
    n = jax.jit(lambda s: s.p0.sum())(scene)
    assert n.shape == ()


def test_in_repo_scenes():
    """scenes/ holds scene_2 (three spheres, no light: NEE off) and the
    single-light room (cubes + spheres, one emitter: NEE and the
    occlusion shadow path run)."""
    from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file

    s2 = parse_scene_file(scene_file("scene_2"))
    assert s2.obj_type == (OBJ_SPHERE,) * 3 and s2.light_index == -1
    np.testing.assert_allclose(np.asarray(s2.p0)[:, 0], [-3, 0, 3])
    room = parse_scene_file(scene_file("room"))
    assert OBJ_CUBE in room.obj_type and OBJ_SPHERE in room.obj_type
    assert sum(room.emissive) == 1 and room.emissive[room.light_index]
    with pytest.raises(FileNotFoundError):
        scene_file("no_such_scene")
