"""Multi-device rendering over ``torch.distributed``: row bands
(``sharding.py``, the scene replicated) and scene shards
(``scene_shard.py``, the geometry split), with the process groups of
``group.py`` in the place of the JAX package's device mesh. Each frame
entry has a ``compiled_`` counterpart, captured per rank as a CUDA graph
(``COMPILED_SHARDED``; ``render.pipeline.clear_compiled`` clears them)."""

from .group import Group, PerRank, make_group, spawn
from .scene_shard import (
    SceneShard,
    cast_rays_scene_sharded,
    compiled_render_image_path_scene_sharded,
    compiled_render_image_scene_sharded,
    compiled_render_image_whitted_scene_sharded,
    render_image_path_scene_sharded,
    render_image_scene_sharded,
    render_image_whitted_scene_sharded,
    shard_compile,
)
from .sharding import (
    check_sharded_config,
    compiled_render_image_path_traced_sharded,
    compiled_render_image_sharded,
    compiled_render_image_whitted_sharded,
    render_image_path_traced_sharded,
    render_image_sharded,
    render_image_whitted_sharded,
)

COMPILED_SHARDED = (
    compiled_render_image_sharded, compiled_render_image_whitted_sharded,
    compiled_render_image_path_traced_sharded, compiled_render_image_scene_sharded,
    compiled_render_image_whitted_scene_sharded, compiled_render_image_path_scene_sharded,
)

__all__ = [
    "COMPILED_SHARDED",
    "Group",
    "PerRank",
    "SceneShard",
    "cast_rays_scene_sharded",
    "check_sharded_config",
    "compiled_render_image_path_scene_sharded",
    "compiled_render_image_path_traced_sharded",
    "compiled_render_image_scene_sharded",
    "compiled_render_image_sharded",
    "compiled_render_image_whitted_scene_sharded",
    "compiled_render_image_whitted_sharded",
    "make_group",
    "render_image_path_scene_sharded",
    "render_image_path_traced_sharded",
    "render_image_scene_sharded",
    "render_image_sharded",
    "render_image_whitted_sharded",
    "render_image_whitted_scene_sharded",
    "shard_compile",
    "spawn",
]
