"""Dry run of the multi-device layer: every sharded entry once, at 64
pixels wide, on ``--world-size`` ranks, through its compiled entry
point.

    python -m tpu_raytracer_torch.parallel.dryrun --world-size 2 --device cpu
    python -m tpu_raytracer_torch.parallel.dryrun --world-size 1 --device cuda:0
    python -m tpu_raytracer_torch.parallel.dryrun --world-size 2 --device cuda:0 --backend gloo

The counterpart of ``__graft_entry__.py:dryrun_multichip``, which runs
the JAX package's jitted sharded entries. Row bands: the primary,
Whitted and path renders of a two-instance scene (a sphere and a
textured cube) at 64 x 32n pixels; scene shards: the primary
(``lambert_shadow``), Whitted and path renders of a sphere split into n
chunks, at 64x64. All through the ``cuda`` backend (K3 for the
two-instance scene, K1 for the chunks; their plain versions on the CPU).
Each rank renders every frame through its ``compiled_`` entry point (one
CUDA graph per rank on CUDA) and once through the eager one; the run
checks that each compiled frame is its eager frame bit for bit, the
shapes, that every rank holds the same image and that it shows the
scene, and prints one line naming what ran. A gloo group on CUDA cannot
capture the scene shards' collectives: there their compiled entry points
must raise, and the line says so. Without ``--device`` rank i runs on
``cuda:i``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..render.camera import Camera
from ..render.pipeline import RenderConfig
from ..utils import prng
from .group import PerRank, default_backend, spawn

SKY = np.array([255, 204, 153], np.uint8)


def _rows_scene(width: int, height: int):
    """``__graft_entry__._small_scene``: a red icosphere and a
    checkerboard cube, two instances."""
    from ..scene import Material, MeshInstance, MeshPrimitive, Scene, objloader, procgen

    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    tex = Material()
    tex.set_texture(procgen.checkerboard_texture(64, 8))
    scene.add_material(tex)
    scene.add_mesh(MeshPrimitive.from_triangles(*procgen.icosphere(3)))
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    b = MeshInstance(1, 1)
    b.pose = np.array([1.2, 0.8, 0.0, 0.2, 0.0, 0.4], np.float32)
    scene.add_mesh_instance(MeshInstance(0, 0))
    scene.add_mesh_instance(b)
    return scene, Camera.looking(width, height, fov_deg=55.0, pose=[0, -4, 0, 0, 0, 0])


def _shard_scene():
    from ..scene import Material, MeshInstance, MeshPrimitive, Scene, procgen

    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    scene.add_mesh(MeshPrimitive.from_triangles(*procgen.icosphere(2)))
    scene.add_mesh_instance(MeshInstance(0, 0))
    return scene, Camera.looking(64, 64, fov_deg=45.0, pose=[0, -3.5, 0, 0, 0, 0])


def rank_frames(group, rows, rows_params, shard, shard_params) -> dict:
    """One rank's frames of every sharded entry (a ``spawn`` worker):
    {name: (compiled frame, or the ``ValueError`` of a compiled entry
    point that cannot capture on this group, as a string; eager frame)}."""
    from . import scene_shard, sharding

    scene = rows.to(group.device)
    args = [rows_params[k] for k in ("K_inv", "D", "pose", "inv_pose")]
    cfg = RenderConfig(64, rows_params["height"], backend="cuda")
    key = prng.PRNGKey(0)
    shard = shard.to(group.device)
    sargs = [shard_params[k] for k in ("K_inv", "D", "pose", "inv_pose")]
    scfg = RenderConfig(64, 64, backend="cuda", lighting="lambert_shadow")
    frames = {
        "rows_primary": (sharding, "render_image_sharded", cfg, scene, args, ()),
        "rows_whitted": (sharding, "render_image_whitted_sharded", cfg, scene, args, ()),
        "rows_path": (sharding, "render_image_path_traced_sharded", cfg, scene, args,
                      (key, 1, 1)),
        "shards_primary": (scene_shard, "render_image_scene_sharded", scfg, shard, sargs, ()),
        "shards_whitted": (scene_shard, "render_image_whitted_scene_sharded", scfg, shard,
                           sargs, (1,)),
        "shards_path": (scene_shard, "render_image_path_scene_sharded", scfg, shard, sargs,
                        (key, 1, 1)),
    }
    out = {}
    for name, (mod, entry, c, sc, a, extra) in frames.items():
        try:
            fast = getattr(mod, "compiled_" + entry)(c, group, sc, *a, *extra)
        except ValueError as e:
            fast = str(e)
        out[name] = (fast, getattr(mod, entry)(c, group, sc, *a, *extra))
    return out


def dryrun(world_size: int, device=None, backend: str | None = None) -> str:
    """Run every sharded entry on ``world_size`` new ranks, check what
    they return, and return the line that names what ran."""
    from .scene_shard import shard_compile
    from .sharding import gather_route

    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    backend = backend or default_backend(dev)
    height = 32 * world_size
    rows, cam = _rows_scene(64, height)
    rows_params = dict(cam.ray_params("cpu"), height=height)
    src, scam = _shard_scene()
    shards = shard_compile(src, world_size, device="cpu")
    results = spawn(rank_frames, world_size, device=device, backend=backend,
                    args=(rows.compile("cpu"), rows_params, PerRank(tuple(shards)),
                          scam.ray_params("cpu")))
    capturable = dev.type == "cpu" or backend == "nccl"
    for name, (fast, img) in results[0].items():
        want = (height if name.startswith("rows") else 64, 64, 3)
        if tuple(img.shape) != want or img.dtype != torch.uint8:
            raise AssertionError(f"{name}: {tuple(img.shape)} {img.dtype}, not {want} uint8")
        for r, res in enumerate(results):
            other, eager = res[name]
            if r and not torch.equal(eager, img):
                raise AssertionError(f"{name}: rank {r}'s image differs from rank 0's")
            if name.startswith("rows") or capturable:
                if not (isinstance(other, torch.Tensor) and torch.equal(other, eager)):
                    raise AssertionError(f"{name}: rank {r}'s compiled frame is not its eager "
                                         f"frame ({other if isinstance(other, str) else ''})")
            elif not (isinstance(other, str) and "NCCL" in other):
                raise AssertionError(f"{name}: the compiled entry point did not refuse a "
                                     f"{backend} group on {dev}")
        if not (img.numpy() != SKY).any(-1).any():
            raise AssertionError(f"{name}: no pixel shows the scene")
    shards_how = ("compiled == eager" if capturable else
                  f"compiled refused ({backend} on CUDA cannot capture collectives), eager")
    return (f"dryrun OK on {world_size} ranks (device {device or 'cuda:{rank}'}, "
            f"backend {backend}, bands gathered by {gather_route(backend, dev)}): row bands "
            f"primary/whitted/path at 64x{height} compiled == eager, scene shards "
            f"primary/whitted/path at 64x64 in {world_size} chunks of "
            f"{shards[0].scene.num_triangles} rows {shards_how}, backend cuda")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--device", default=None,
                    help="one device for every rank (cpu, cuda:0); default cuda:{rank}")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on CUDA devices, gloo on the CPU")
    a = ap.parse_args(argv)
    print(dryrun(a.world_size, a.device, a.backend), flush=True)


if __name__ == "__main__":
    main()
