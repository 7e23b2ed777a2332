"""Scene container and its compilation to flat tensors.

Counterpart of ``tpu_raytracer/scene/scene.py``. ``Scene.compile``
flattens meshes, BVHs, instances, materials and textures into one
``SceneTensors`` — a plain dataclass of tensors on one ``device`` —
reproducing the JAX compile field by field:

  * each mesh's leaves are re-packed 8-aligned with all-zero padding
    triangles, so triangle ids equal the JAX ids;
  * node boxes are out-rounded by ``BOX_PAD_ULP`` of their magnitude;
  * textures (with their mip chains) are packed into one i32 atlas,
    one ``r | g << 8 | b << 16`` word per texel.

``from_scene_arrays`` is the other way in: it takes a JAX-compiled
``SceneArrays`` as a dict of numpy arrays, so the two packages can be
run on the identical scene (``from_stacked_shard`` takes one chunk of
its scene-sharded compile). Both attach every scene's triangle records
(``tri_rec``) and then decide in one place (``_assemble``) how the scene
is cast, by ``SceneTensors.needs_paging`` (``kernels/traversal.py
needs_paging``): a scene whose triangle rows reach ``PAGING_ROWS``
(2,097,152, the rows a leaf code can address) needs paging, and no
smaller one does (a paged cast beat K1's at no size the card measured
below it). A resident scene gets the 4-wide tables of K1, the binary
tables of K2 and, for two or more instances, the TLAS of K3; a scene
that needs paging gets 4-wide page tables (``with_paging``) and none of
those, and every cast of the ``cuda`` and ``bvh`` backends goes to the
paged kernel K4. ``compile(auto_page=False)`` raises for such a scene,
as the scene shards' resident chunks do. ``update_instance`` is the functional pose update that
rebuilds the TLAS, and ``with_paging`` attaches the page tables of the
paged kernels K4-K6 to any scene, which the ``paged`` and
``paged_major`` backends need. Meshes
with vertex normals give ``tri_vnorm`` (10 lanes per triangle: the three
corners' normals and a flag, zero on the pad rows), and
``Scene.set_sky`` packs an equirect sky map at the atlas's tail
(``sky_tex_*``).

``Scene.flattened`` bakes every instance into one world-space mesh with
per-triangle materials (``tri_mat``), which ``compile(flatten_static=
True)`` compiles: one instance, cast by K1 instead of K3.
``SceneTensors.save`` and ``load`` keep a compiled scene in the JAX
package's npz format (an npz saved by either package loads in the
other); ``scene/cache.py`` builds a compile cache on them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import setup
from .instance import MeshInstance
from .material import Material
from .mesh import MeshPrimitive

# Relative out-rounding of BVH node boxes (the JAX compile's default):
# the f32 triangle test accepts grazing hits ~1 coordinate ulp outside
# a triangle, and tight boxes would cull them.
BOX_PAD_ULP = 2.0 ** -21

# Array fields of SceneTensors, in the JAX SceneArrays' names and order.
ARRAY_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "tri_normal", "tri_uv0", "tri_uv1",
    "tri_uv2", "tri_mesh", "tri_mat",
    "node_min", "node_max", "node_child_a", "node_child_b",
    "node_leaf_start", "node_leaf_count", "mesh_root",
    "inst_mesh", "inst_material", "inst_pose", "inst_inv_pose",
    "inst_scale", "inst_inv_scale",
    "mat_albedo", "mat_roughness", "mat_metallic", "mat_illumination",
    "mat_reflectivity", "mat_tex_start", "mat_tex_w", "mat_tex_h",
    "tex_atlas", "mat_tex_mip_start", "sky_tex_start", "sky_tex_w",
    "sky_tex_h",
)


def _mip_downsample(level: np.ndarray) -> np.ndarray:
    """One mip level down: 2x2 box filter, floor halving, edge repeat
    for a dimension that is already 1."""
    h, w, _ = level.shape
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    src = level[: 2 * nh if h > 1 else 1, : 2 * nw if w > 1 else 1]
    if h == 1:
        src = np.repeat(src, 2, axis=0)
    if w == 1:
        src = np.repeat(src, 2, axis=1)
    f = src.astype(np.float32).reshape(nh, 2, nw, 2, 3).mean(axis=(1, 3))
    return np.round(f).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class SceneTensors:
    """Flat scene: every tensor the render path needs, on ``device``.
    Field meanings are those of the JAX ``SceneArrays``."""

    tri_v0: torch.Tensor  # [T, 3] f32, BVH-leaf order, 8-aligned leaves
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_normal: torch.Tensor
    tri_uv0: torch.Tensor  # [T, 2] f32
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_mesh: torch.Tensor  # [T] i32
    tri_mat: torch.Tensor  # [T] i32, -1 = the instance's material
    node_min: torch.Tensor  # [N, 3] f32
    node_max: torch.Tensor
    node_child_a: torch.Tensor  # [N] i32, -1 = leaf
    node_child_b: torch.Tensor
    node_leaf_start: torch.Tensor
    node_leaf_count: torch.Tensor
    mesh_root: torch.Tensor  # [M] i32
    inst_mesh: torch.Tensor  # [I] i32
    inst_material: torch.Tensor
    inst_pose: torch.Tensor  # [I, 6] f32 lre
    inst_inv_pose: torch.Tensor
    inst_scale: torch.Tensor  # [I, 3] f32
    inst_inv_scale: torch.Tensor
    mat_albedo: torch.Tensor  # [K, 3] f32
    mat_roughness: torch.Tensor  # [K] f32
    mat_metallic: torch.Tensor
    mat_illumination: torch.Tensor
    mat_reflectivity: torch.Tensor
    mat_tex_start: torch.Tensor  # [K] i32, -1 = untextured
    mat_tex_w: torch.Tensor
    mat_tex_h: torch.Tensor
    tex_atlas: torch.Tensor  # [P] i32 packed texels
    mat_tex_mip_start: torch.Tensor  # [K, L] i32
    sky_tex_start: torch.Tensor  # [] i32, -1 = flat sky
    sky_tex_w: torch.Tensor
    sky_tex_h: torch.Tensor
    # [T, 10] f32 per-corner vertex normals (vn0, vn1, vn2) and a flag
    # (lane 9: the face had them); None when no mesh has vertex normals
    tri_vnorm: torch.Tensor | None = None
    has_sky: bool = False
    has_textures: bool = True
    has_emissive: bool = True
    # [T, 16] f32 triangle records (kernels/wide4.py build_tri_rec), which
    # every kernel reads; every compiled scene has them
    tri_rec: torch.Tensor | None = None
    # 4-wide traversal tables (kernels/wide4.py Wide4Tables, holding the
    # same tri_rec); every resident scene has them, no scene that needs
    # paging does
    wide4: object | None = None
    # instance-level BVH (kernels/tlas.py TlasTables), attached to
    # resident scenes of two or more instances
    tlas: object | None = None
    # page tables of the paged kernels (kernels/paged.py PagedTables),
    # attached by with_paging, and by the compile to scenes that need
    # paging
    paged: object | None = None
    # binary traversal tables of K2 (kernels/binary.py BinaryTables);
    # every resident scene has them
    binary: object | None = None

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_instances(self) -> int:
        return self.inst_mesh.shape[0]

    def to(self, device) -> "SceneTensors":
        """The same scene with every tensor on ``device``."""
        moved = {f: getattr(self, f).to(device) for f in ARRAY_FIELDS}
        for f in ("tri_vnorm", "tri_rec", "tlas", "paged", "binary"):
            moved[f] = None if getattr(self, f) is None else getattr(self, f).to(device)
        if self.wide4 is not None:  # one copy of the records, shared as on the host
            moved["wide4"] = dataclasses.replace(self.wide4, tri_rec=moved["tri_rec"]).to(device)
        return dataclasses.replace(self, **moved)

    def needs_paging(self) -> bool:
        """True when the scene is cast through page tables: its triangle
        rows reach the resident kernels' limit (``kernels/traversal.py
        needs_paging``; the JAX package's ``SceneArrays.needs_paging``)."""
        from ..kernels.traversal import needs_paging

        return needs_paging(self)

    def update_instance(self, index: int, instance: MeshInstance) -> "SceneTensors":
        """Functional single-instance update (pose, scale, mesh and
        material), the cheap animation path: the per-mesh wide and binary
        tables stay, and the TLAS, where the scene has one, is rebuilt on the
        host."""
        inv = instance.build_inv()
        values = {
            "inst_pose": inv["pose"], "inst_inv_pose": inv["inv_pose"],
            "inst_scale": inv["scale"], "inst_inv_scale": inv["inv_scale"],
            "inst_mesh": instance.mesh_index, "inst_material": instance.material_index,
        }
        fields = {}
        for name, value in values.items():
            x = getattr(self, name).clone()
            x[index] = torch.as_tensor(value, dtype=x.dtype)
            fields[name] = x
        new = dataclasses.replace(self, tlas=None, **fields)
        if self.tlas is not None:
            from ..kernels.tlas import build_tlas

            new = dataclasses.replace(new, tlas=build_tlas(new))
        return new

    def with_paging(self, page_tris: int | None = None, page_nodes: int | None = None,
                    wide: bool = True) -> "SceneTensors":
        """The same scene with page tables attached (``kernels/paged.py
        prepare_paged``; default capacities the JAX package's): 4-wide
        pages for K4 and K6 with ``wide``, binary pages for K5 without.
        Host work, once per scene: the scene itself comes back when tables
        of that arity and those capacities are attached already. The build
        is the set-up span ``setup.paging`` (inside ``setup.compile`` where
        the compile attaches the tables), its info ``pages``, ``rows``
        (the scene's triangle rows) and ``bytes`` (the tables' tensors)."""
        from ..kernels.paged import PAGE_NODES, PAGE_TRIS, prepare_paged

        tris = PAGE_TRIS if page_tris is None else page_tris
        nodes = PAGE_NODES if page_nodes is None else page_nodes
        pg = self.paged
        if pg is not None and (pg.arity, pg.page_tris, pg.page_nodes) == (
                4 if wide else 2, tris, nodes):
            return self
        with setup("paging") as span:
            pg = prepare_paged(self, tris, nodes, wide)
            span.info = {"pages": pg.num_pages, "rows": self.num_triangles,
                         "bytes": sum(t.nbytes for t in vars(pg).values()
                                      if isinstance(t, torch.Tensor))}
        return dataclasses.replace(self, paged=pg)

    def save(self, fp: str) -> None:
        """Write the array fields to an npz (the JAX ``SceneArrays.save``
        format: the same keys, ``tri_vnorm`` only where present, no
        derived tables or flags)."""
        np.savez_compressed(fp, **self.numpy_fields())

    @classmethod
    def load(cls, fp: str, device="cuda") -> "SceneTensors":
        """Read an npz written by ``save`` or by the JAX package's
        ``SceneArrays.save``; the derived tables and flags are rebuilt, and
        files from before mip chains or sky maps take their defaults."""
        with np.load(fp) as data:
            fields = {k: data[k] for k in data.files}
        return from_scene_arrays(fields, device)

    def numpy_fields(self) -> dict[str, np.ndarray]:
        """Array fields as host numpy arrays, keyed by field name
        (``tri_vnorm`` where the scene has it)."""
        out = {f: getattr(self, f).cpu().numpy() for f in ARRAY_FIELDS}
        if self.tri_vnorm is not None:
            out["tri_vnorm"] = self.tri_vnorm.cpu().numpy()
        return out


def from_scene_arrays(fields: dict[str, np.ndarray], device="cuda",
                      auto_page: bool = True) -> SceneTensors:
    """Build ``SceneTensors`` from a JAX-compiled ``SceneArrays`` given
    as numpy arrays keyed by field name (missing mip or sky fields take
    the JAX defaults for pre-mip and skyless scenes; ``tri_vnorm`` where
    the scene has vertex normals). The wide tables, or the page tables
    of a scene that needs paging (``auto_page``, as in
    ``Scene.compile``), are rebuilt from the binary BVH exactly as the
    JAX compile builds them."""
    kw = {}
    for name in ARRAY_FIELDS + ("tri_vnorm",):
        if fields.get(name) is not None:
            kw[name] = np.asarray(fields[name])
    kw.setdefault("mat_tex_mip_start", kw["mat_tex_start"][:, None])
    kw.setdefault("sky_tex_start", np.int32(-1))
    kw.setdefault("sky_tex_w", np.int32(0))
    kw.setdefault("sky_tex_h", np.int32(0))
    return _assemble(kw, device, auto_page)


def from_stacked_shard(fields: dict[str, np.ndarray], shard: int,
                       device="cuda") -> tuple[SceneTensors, int]:
    """One chunk of the JAX package's scene-sharded compile
    (``parallel.scene_shard.shard_compile``: every field stacked on a
    leading shard axis, each chunk padded to the largest) as
    ``SceneTensors``, and the stride of its global triangle ids (the
    padded triangle rows). The stacking's padding is cut off: triangle
    rows where ``tri_mesh`` is -1, node rows where ``node_leaf_count`` is
    -1. The chunk is resident, as the JAX package's chunks are."""
    one = {k: np.asarray(v)[shard] for k, v in fields.items() if v is not None}
    stride = one["tri_v0"].shape[0]
    n_tri = int((one["tri_mesh"] >= 0).sum())
    n_node = int((one["node_leaf_count"] >= 0).sum())
    for k in list(one):
        if k.startswith("tri_"):
            one[k] = one[k][:n_tri]
        elif k.startswith("node_"):
            one[k] = one[k][:n_node]
    return from_scene_arrays(one, device, auto_page=False), stride


def _assemble(kw: dict[str, np.ndarray], device, auto_page: bool = True) -> SceneTensors:
    """The scene of array fields ``kw`` on ``device`` with its derived
    tables: the one place that decides how a scene is cast. A scene that
    needs paging gets 4-wide page tables and no resident tables (the JAX
    compile's ``with_paging``), and raises without ``auto_page``; every
    other one, the 4-wide and binary tables and, for two or more
    instances, the TLAS."""
    from ..kernels.binary import build_binary
    from ..kernels.tlas import build_tlas
    from ..kernels.wide4 import build_tri_rec, build_wide4

    tensors = {k: torch.from_numpy(np.array(v)).to(device) for k, v in kw.items()}
    scene = SceneTensors(
        **tensors,
        has_sky=bool(kw["sky_tex_start"] >= 0),
        has_textures=bool((kw["mat_tex_start"] >= 0).any()),
        has_emissive=bool((kw["mat_illumination"] > 0).any()),
    )
    scene = dataclasses.replace(scene, tri_rec=build_tri_rec(scene))
    if scene.needs_paging():
        if not auto_page:
            raise ValueError(
                f"the scene needs paging: its {scene.num_triangles} triangle rows reach "
                f"PAGING_ROWS (kernels/traversal.py; the leaf code's LEAF_ROWS), past the "
                "resident tables; compile it with auto_page=True, which attaches page "
                "tables (SceneTensors.with_paging)")
        return scene.with_paging()
    scene = dataclasses.replace(scene, wide4=build_wide4(scene, scene.tri_rec),
                                binary=build_binary(scene))
    if scene.num_instances >= 2:
        scene = dataclasses.replace(scene, tlas=build_tlas(scene))
    return scene


class Scene:
    """Host-side scene builder."""

    def __init__(self):
        self.materials: list[Material] = []
        self.meshes: list[MeshPrimitive] = []
        self.mesh_instances: list[MeshInstance] = []
        self.sky_texture: np.ndarray | None = None

    def set_sky(self, texture: np.ndarray) -> None:
        """Attach an equirectangular environment map, sampled by the
        direction of rays that miss: [H, W, 3] uint8 in the material
        textures' channel order."""
        texture = np.asarray(texture, np.uint8)
        if texture.ndim != 3 or texture.shape[2] != 3:
            raise ValueError(f"sky must be [H, W, 3] uint8, got {texture.shape}")
        self.sky_texture = texture

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_mesh(self, mesh: MeshPrimitive) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_mesh_instance(self, instance: MeshInstance) -> int:
        self.mesh_instances.append(instance)
        return len(self.mesh_instances) - 1

    def update_mesh_instance(self, index: int, instance: MeshInstance) -> None:
        self.mesh_instances[index] = instance

    def flattened(self) -> tuple["Scene", np.ndarray]:
        """Every instance's triangles baked to world space and merged into
        one mesh under one identity instance: the new Scene, and the
        per-triangle material ids in the merged mesh's BVH order.

        For scenes whose instances do not move: one walk over one BVH
        replaces the walk over every instance, at the price of the cheap
        pose update. The bake is ``hit_attributes``' transform: world =
        apply_lre(inv_pose, v * scale), normals (face and vertex) by the
        scale-multiply convention, renormalised. The sky map stays behind, as
        in the JAX package: the flattened scene renders the flat sky colour."""
        from ..core import transforms as T
        from ..core.vecmath import normalize

        parts = {k: [] for k in ("v0", "v1", "v2", "normal", "uv0", "uv1", "uv2", "mat",
                                 "vn0", "vn1", "vn2", "vn_mask")}
        any_vn = any(self.meshes[i.mesh_index].vn0 is not None for i in self.mesh_instances)
        for inst in self.mesh_instances:
            mesh = self.meshes[inst.mesh_index]
            d = inst.build_inv()
            inv_pose = torch.from_numpy(np.asarray(d["inv_pose"], np.float32))
            scale = torch.from_numpy(np.asarray(d["scale"], np.float32))

            def to_world(v):
                return T.apply_lre(inv_pose, torch.from_numpy(v) * scale).numpy()

            def to_world_n(n):
                return normalize(T.apply_euler(inv_pose[3:6], torch.from_numpy(n))
                                 * scale).numpy()

            for k in ("v0", "v1", "v2"):
                parts[k].append(to_world(getattr(mesh, k)))
            parts["normal"].append(to_world_n(mesh.normal))
            for k in ("uv0", "uv1", "uv2"):
                parts[k].append(getattr(mesh, k))
            parts["mat"].append(np.full(mesh.num_triangles, inst.material_index, np.int32))
            if any_vn:
                zeros = np.zeros((mesh.num_triangles, 3), np.float32)
                for k in ("vn0", "vn1", "vn2"):
                    vn = getattr(mesh, k)
                    parts[k].append(zeros if vn is None else to_world_n(vn))
                parts["vn_mask"].append(np.zeros(mesh.num_triangles, bool)
                                        if mesh.vn_mask is None else mesh.vn_mask)

        cat = {k: np.concatenate(v) if v else None for k, v in parts.items()}
        merged = MeshPrimitive.from_triangles(
            *(cat[k] for k in ("v0", "v1", "v2", "normal", "uv0", "uv1", "uv2")),
            **{k: cat[k] for k in ("vn0", "vn1", "vn2", "vn_mask")})
        flat = Scene()
        flat.materials = self.materials
        flat.add_mesh(merged)
        flat.add_mesh_instance(MeshInstance(0, 0))
        return flat, cat["mat"][merged.bvh.order]

    def compile(self, device="cuda", box_pad_ulp: float = BOX_PAD_ULP,
                flatten_static: bool = False, auto_page: bool = True,
                _tri_mat: np.ndarray | None = None) -> SceneTensors:
        """Flatten to ``SceneTensors`` on ``device``, with the 4-wide
        traversal tables and, for two or more instances, the TLAS
        attached, or, for a scene that needs paging
        (``SceneTensors.needs_paging``) and ``auto_page``, page tables in
        their place (``_assemble``). ``box_pad_ulp``: the node boxes'
        relative out-rounding (0 for tight boxes). ``flatten_static``:
        compile ``flattened()`` instead, one instance with per-triangle
        materials (``tri_mat``, the source instance's material; -1
        elsewhere and on pad rows). ``auto_page=False`` builds the
        resident tables, and raises for a scene that needs paging.

        The set-up span ``setup.compile``; where the scene has 4-wide
        tables, its info ``wide_sah`` and ``wide_triangles``, per mesh
        (``kernels/wide4.py wide_sah``)."""
        from ..kernels.wide4 import wide_sah

        with setup("compile") as span:
            if not self.meshes or not self.mesh_instances or not self.materials:
                raise ValueError("scene needs at least one mesh, instance and material")
            if flatten_static:
                flat, tri_mat = self.flattened()
                scene = flat._compile(device, box_pad_ulp, auto_page, tri_mat)
            else:
                scene = self._compile(device, box_pad_ulp, auto_page, _tri_mat)
            if scene.wide4 is not None:
                costs = wide_sah(scene.wide4)
                span.info = {"wide_sah": [c for c, _ in costs],
                             "wide_triangles": [t for _, t in costs]}
            return scene

    def _compile(self, device, box_pad_ulp: float, auto_page: bool,
                 _tri_mat: np.ndarray | None) -> SceneTensors:
        """``compile``'s scene, of this scene's meshes and instances as they are."""
        tri_parts = {k: [] for k in ("v0", "v1", "v2", "normal", "uv0", "uv1", "uv2")}
        node_parts = {k: [] for k in ("min", "max", "ca", "cb", "ls", "lc")}
        tri_mesh, tri_mat_parts, mesh_root, vnorm_parts = [], [], [], []
        tri_off = node_off = 0
        for mesh_id, mesh in enumerate(self.meshes):
            b = mesh.bvh
            internal = b.child_a >= 0
            idx = np.nonzero(internal)[0]
            if not (b.child_a[idx] == idx + 1).all():
                raise ValueError("BVH not DFS preorder")
            if not b.leaf_count.max(initial=0) < 1024:
                raise ValueError(
                    f"leaf with {b.leaf_count.max()} triangles exceeds the "
                    "kernel's 10-bit leaf size (degenerate mesh?)"
                )
            # 8-aligned leaf layout: every leaf block starts at a multiple
            # of 8; gaps hold all-zero triangles (normal 0 fails every
            # denominator test) that no leaf count covers.
            leaves = np.nonzero(~internal)[0]
            leaves = leaves[np.argsort(b.leaf_start[leaves], kind="stable")]
            counts = b.leaf_count[leaves].astype(np.int64)
            aligned = (counts + 7) // 8 * 8
            new_starts = np.concatenate(([0], np.cumsum(aligned)[:-1]))
            new_total = int(aligned.sum())
            leaf_of_pos = np.repeat(np.arange(len(leaves)), aligned)
            off_in_leaf = np.arange(new_total) - new_starts[leaf_of_pos]
            src = b.leaf_start[leaves][leaf_of_pos] + off_in_leaf
            pad = off_in_leaf >= counts[leaf_of_pos]
            src = np.where(pad, 0, src)

            tri_mesh.append(np.full(new_total, mesh_id, np.int32))
            # per-triangle materials (flattened scenes); -1 resolves through
            # the instance, and pad rows get -1
            mat_src = (_tri_mat if _tri_mat is not None and mesh_id == 0
                       else np.full(mesh.num_triangles, -1, np.int32))
            tri_mat_parts.append(np.where(pad, np.int32(-1), mat_src[src]).astype(np.int32))
            if mesh.vn0 is not None:
                vn = np.concatenate([mesh.vn0, mesh.vn1, mesh.vn2,
                                     mesh.vn_mask[:, None].astype(np.float32)], axis=1)
            else:
                vn = np.zeros((mesh.num_triangles, 10), np.float32)
            vnorm_parts.append(np.where(pad[:, None], np.float32(0.0), vn[src]))
            for k, arr in (
                ("v0", mesh.v0), ("v1", mesh.v1), ("v2", mesh.v2),
                ("normal", mesh.normal),
                ("uv0", mesh.uv0), ("uv1", mesh.uv1), ("uv2", mesh.uv2),
            ):
                tri_parts[k].append(np.where(pad[:, None], np.float32(0.0), arr[src]))
            ls = np.zeros(b.num_nodes, np.int64)
            ls[leaves] = new_starts

            node_parts["min"].append(b.node_min)
            node_parts["max"].append(b.node_max)
            node_parts["ca"].append(np.where(internal, b.child_a + node_off, -1).astype(np.int32))
            node_parts["cb"].append(np.where(internal, b.child_b + node_off, -1).astype(np.int32))
            node_parts["ls"].append((ls + tri_off).astype(np.int32))
            node_parts["lc"].append(b.leaf_count)
            mesh_root.append(node_off)
            tri_off += new_total
            node_off += b.num_nodes

        inv = [inst.build_inv() for inst in self.mesh_instances]

        # texture atlas with mip chains (levels past a chain repeat its
        # last 1x1 start)
        atlas_parts, tex_start, tex_w, tex_h, mip_chains = [], [], [], [], []
        p = 0
        for m in self.materials:
            if m.texture is None:
                tex_start.append(-1)
                tex_w.append(0)
                tex_h.append(0)
                mip_chains.append([-1])
                continue
            h, w, _ = m.texture.shape
            chain = []
            level = m.texture
            while True:
                chain.append(p)
                atlas_parts.append(level.reshape(-1, 3))
                p += level.shape[0] * level.shape[1]
                if level.shape[0] <= 1 and level.shape[1] <= 1:
                    break
                level = _mip_downsample(level)
            tex_start.append(chain[0])
            tex_w.append(w)
            tex_h.append(h)
            mip_chains.append(chain)
        # the sky map: one level, no mips, at the atlas's tail
        if self.sky_texture is not None:
            sky_h, sky_w, _ = self.sky_texture.shape
            sky_start = p
            atlas_parts.append(self.sky_texture.reshape(-1, 3))
            p += sky_h * sky_w
        else:
            sky_start, sky_w, sky_h = -1, 0, 0
        max_mips = max(len(c) for c in mip_chains)
        mip_start = np.full((len(self.materials), max_mips), -1, np.int32)
        for k, chain in enumerate(mip_chains):
            if chain[0] >= 0:
                mip_start[k] = chain + [chain[-1]] * (max_mips - len(chain))
        atlas_u8 = (
            np.concatenate(atlas_parts, axis=0) if atlas_parts
            else np.zeros((1, 3), np.uint8)
        )
        a32 = atlas_u8.astype(np.int32)
        atlas = a32[:, 0] | (a32[:, 1] << 8) | (a32[:, 2] << 16)

        cat = np.concatenate
        node_min = cat(node_parts["min"])
        node_max = cat(node_parts["max"])
        if box_pad_ulp:
            pad = np.maximum(np.abs(node_min), np.abs(node_max)) * np.float32(box_pad_ulp)
            node_min = node_min - pad
            node_max = node_max + pad

        f32 = lambda x: np.asarray(x, np.float32)
        i32 = lambda x: np.asarray(x, np.int32)
        kw = dict(
            tri_v0=f32(cat(tri_parts["v0"])),
            tri_v1=f32(cat(tri_parts["v1"])),
            tri_v2=f32(cat(tri_parts["v2"])),
            tri_normal=f32(cat(tri_parts["normal"])),
            tri_uv0=f32(cat(tri_parts["uv0"])),
            tri_uv1=f32(cat(tri_parts["uv1"])),
            tri_uv2=f32(cat(tri_parts["uv2"])),
            tri_mesh=i32(cat(tri_mesh)),
            tri_mat=i32(cat(tri_mat_parts)),
            node_min=f32(node_min),
            node_max=f32(node_max),
            node_child_a=i32(cat(node_parts["ca"])),
            node_child_b=i32(cat(node_parts["cb"])),
            node_leaf_start=i32(cat(node_parts["ls"])),
            node_leaf_count=i32(cat(node_parts["lc"])),
            mesh_root=i32(mesh_root),
            inst_mesh=i32([inst.mesh_index for inst in self.mesh_instances]),
            inst_material=i32([inst.material_index for inst in self.mesh_instances]),
            inst_pose=f32([d["pose"] for d in inv]),
            inst_inv_pose=f32([d["inv_pose"] for d in inv]),
            inst_scale=f32([d["scale"] for d in inv]),
            inst_inv_scale=f32([d["inv_scale"] for d in inv]),
            mat_albedo=f32([m.albedo for m in self.materials]),
            mat_roughness=f32([m.roughness for m in self.materials]),
            mat_metallic=f32([m.metallic for m in self.materials]),
            mat_illumination=f32([m.illumination for m in self.materials]),
            mat_reflectivity=f32([m.reflectivity for m in self.materials]),
            mat_tex_start=i32(tex_start),
            mat_tex_w=i32(tex_w),
            mat_tex_h=i32(tex_h),
            tex_atlas=i32(atlas),
            mat_tex_mip_start=mip_start,
            sky_tex_start=i32(sky_start),
            sky_tex_w=i32(sky_w),
            sky_tex_h=i32(sky_h),
        )
        if any(m.vn0 is not None for m in self.meshes):
            kw["tri_vnorm"] = f32(cat(vnorm_parts))
        return _assemble(kw, device, auto_page)
