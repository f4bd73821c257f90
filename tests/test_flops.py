"""FLOP census invariants (utils/flops.py): the counted cost of the
forward kernel's physics follows the scene's topology and the loop
lengths it is traced with."""

import dataclasses

import pytest

from ray_tracing_tpu import RenderConfig
from ray_tracing_tpu.scene.parser import parse_scene_file, scene_file
from ray_tracing_tpu.utils import flops as F


def test_physics_cost_tracks_occlusion_shadow_path():
    """physics_cost_per_pixel keys on Scene.emissive: the occlusion
    shadow path (1-plane trace) must be priced cheaper than the exact
    full scan the emissive=None opt-out runs."""
    cfg = RenderConfig(bounces=3, shadow_samples=2)
    scene = parse_scene_file(scene_file("room"))
    occl = F.physics_cost_per_pixel(scene, cfg)["flops_per_px"]
    exact = F.physics_cost_per_pixel(
        dataclasses.replace(scene, emissive=None), cfg)["flops_per_px"]
    assert occl < exact, (occl, exact)


def test_physics_cost_counts_every_bounce_and_shadow_ray():
    """The census walks the bounce loop's scan `bounces` times, and NEE
    adds per-shadow-sample work: doubling bounces roughly doubles the
    cost, and shadow_samples=0 (NEE off) costs less than 2."""
    scene = parse_scene_file(scene_file("room"))
    c2 = F.physics_cost_per_pixel(scene, RenderConfig(bounces=2))
    c4 = F.physics_cost_per_pixel(scene, RenderConfig(bounces=4))
    assert c4["flops_per_px"] == pytest.approx(2 * c2["flops_per_px"], rel=0.1)
    assert c2["transcendentals_per_px"] > 0
    off = F.physics_cost_per_pixel(
        scene, RenderConfig(bounces=2, shadow_samples=0))["flops_per_px"]
    assert off < c2["flops_per_px"]


def test_rays_per_sample_model():
    cfg = RenderConfig()
    assert F.rays_per_sample(4, 2, cfg) == 4 * 2 * 10 * 4
