"""The frame's stages around the cast as hand-written kernels: S1 raygen,
S2 hit attributes, S3 primary shade, S4 sample, S5 Whitted shade and S6
path bounce (``csrc/frame.cu``, per-ray math in ``csrc/frame.cuh``).

The JAX package jits its frame, so XLA fuses the work on each side of the
Pallas cast into a few passes: raygen before it
(``tpu_raytracer/render/camera.py:113 generate_rays``), the attributes and
the primary shading after it (``render/renderer.py:232 hit_attributes``,
``render/shade.py:385 shade_primary``). The port's counterparts run them
as one kernel each:

  * ``generate_rays_cuda`` (S1) is the kernel of ``render/camera.py
    generate_rays``, whose plain version is ``generate_rays_torch``;
  * ``hit_attributes_cuda`` (S2) of ``render/renderer.py hit_attributes``
    (plain: ``hit_attributes_torch``), every branch: the redo, the carried
    u, v and or n, vertex normals, both normal modes, exact or ``q_rsqrt``
    maths, one or many instances;
  * ``shade_primary_cuda`` (S3) of ``render/shade.py shade_primary``
    (plain: ``shade_primary_torch``) on every config: flat, Lambert,
    Lambert with shadows and Blinn-Phong, point lights, nearest, bilinear
    or trilinear textures or albedo, the flat sky or the scene's sky map.
    The shadow rays' answers come in (``lit``, ``point_occ_t``): the router
    prepares the rays and casts them between S2 and S3;
  * ``sample_cosine_cuda`` (S4) of ``render/integrators.py sample_cosine``
    (plain: ``sample_cosine_torch``, the threefry draws of ``utils/prng.py``
    and ``_cosine_sample``), the path tracer's and AO's ``sample`` stage:
    one draw's cosine-weighted directions, and the path tracer's lobe
    uniforms where asked, from the frame's key folded with a static chain
    of words (``split(key, n)[i]`` is ``fold_in(key, i)``), every uint32
    word of the hash in registers. The key is read through a device
    pointer and derived once per block; the normals through their
    strides, so a batch expanded over the samples is not copied;
  * ``whitted_shade_cuda`` (S5) of ``render/integrators.py whitted_shade``
    (plain: ``whitted_shade_torch``), one Whitted bounce's ``shade`` stage:
    the sky on a miss (flat or the sky map), the surface colour (nearest,
    or bilinear for the bilinear and trilinear filters), the clamped light
    term, the materials' reflectivity and emission, the radiance and
    throughput sums updated in place, and the next bounce's reflected rays,
    offset and parked. The first bounce takes no state, the last writes
    no rays;
  * ``path_bounce_cuda`` (S6) of ``render/integrators.py path_bounce``
    (plain: ``path_bounce_torch``), one path-tracing bounce's ``bounce``
    stage after its S4 draw: the sky on a miss times its strength, the
    surface colour (as S5's), the emission, the throughput, the light term
    where NEE is on, the glossy lobe blended toward the cosine sample and
    chosen by the lobe uniform, and the next bounce's rays, offset and
    parked; or, in its tail mode, the fast tail's sky term after the
    any-hit cast. The state is updated in place (the first bounce takes
    none); the batched wavefront's first bounce hands its rays and hit
    attributes expanded over the samples, and they are read through their
    period, not copied.

Each public name routes: a CUDA tensor launches the kernel on the current
stream (outputs allocated with ``torch.empty``) and counts the launch in
``build.LAUNCHES`` (``S1`` to ``S6``), or raises;
a CPU tensor takes the plain version; nothing falls back. Each kernel
repeats its plain version's f32 operations in their order, built with
``--fmad=false``, so the two agree bit for bit on the card, misses
included. The per-frame inputs (the camera, the instance rows) are read
through device pointers, so a CUDA graph replays them as copied in
(``render/compiled.py``). ``*_host`` run the same per-ray code built with
g++ (``csrc/frame_host.cpp``) on CPU tensors, for the tests.
"""

from __future__ import annotations

import functools

import torch

# S4's longest chain of fold_in words (csrc/frame.cuh kMaxChain), and the
# word that folds a draw's key into the path tracer's lobe key:
# fold_in(key_b, 3)
MAX_CHAIN = 4
LOBE_WORD = 3
_WORD = 0xFFFFFFFF

# S3's lighting modes and texture filters and S2's normal modes, as
# csrc/frame.cuh numbers them
MODES = {"flat": 0, "lambert": 1, "lambert_shadow": 2, "blinn_phong": 3}
FILTERS = {"nearest": 0, "bilinear": 1, "trilinear": 2}
NORMAL_MODES = {"reference": 0, "inverse_transpose": 1}

# The modules that bind the routers ``generate_rays``, ``hit_attributes``,
# ``shade_primary``, ``sample_cosine`` and ``whitted_shade`` by name, for
# code that swaps in the plain versions.
ROUTER_MODULES = ("render", "render.camera", "render.renderer", "render.shade",
                  "render.pipeline", "render.integrators", "parallel.sharding",
                  "parallel.scene_shard", "bench_paged")


def _tensor(name: str, x, dtype: torch.dtype, shape: tuple | None = None) -> torch.Tensor:
    """``x`` as a contiguous tensor, after checking its dtype and shape
    (``shape`` None: any)."""
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    return x.contiguous()


def _ptr(x):
    return None if x is None else x.data_ptr()


def _same_device(device: torch.device, **tensors) -> None:
    for name, x in tensors.items():
        if x is not None and x.device != device:
            raise ValueError(f"{name} on {x.device}, expected {device}")


def _entry(device: torch.device, host: bool, name: str, kernel: str):
    """A call of the library function ``frame_<name>`` on its arguments:
    for ``host`` False (CUDA tensors only) the card's launcher on the
    current stream, counted as a launch of ``kernel``, else the host build
    (CPU tensors only). Either raises on a nonzero return."""
    from .build import launch, load

    if host:
        if device.type != "cpu":
            raise ValueError(f"the host build of {name} runs on cpu tensors, got {device}")
        fn = getattr(load("frame_host"), f"frame_{name}_host")

        def call(*args):
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"frame_{name}_host failed with error {err}")

        return call
    if device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on cuda tensors, got {device}")
    return functools.partial(launch, f"frame_{name}_launch", device=device, count=(kernel,))


# ---------------------------------------------------------------------------
# S1 raygen
# ---------------------------------------------------------------------------


def _raygen(width: int, height: int, K_inv, D, pose, inv_pose, exact: bool, host: bool):
    if int(width) <= 0 or int(height) <= 0:
        raise ValueError(f"raygen needs a positive size, got {width}x{height}")
    K_inv = _tensor("K_inv", K_inv, torch.float32, (3, 3))
    D = _tensor("D", D, torch.float32, (4,))
    pose = _tensor("pose", pose, torch.float32, (6,))
    inv_pose = _tensor("inv_pose", inv_pose, torch.float32, (6,))
    dev = K_inv.device
    _same_device(dev, D=D, pose=pose, inv_pose=inv_pose)
    run = _entry(dev, host, "raygen", "S1")
    dirs = torch.empty((int(height), int(width), 3), dtype=torch.float32, device=dev)
    run(int(width), int(height), K_inv.data_ptr(), D.data_ptr(), inv_pose.data_ptr(), int(exact),
        dirs.data_ptr())
    return pose[0:3], dirs


def generate_rays_cuda(width: int, height: int, K_inv, D, pose, inv_pose, exact: bool = True):
    """S1: (origin [3], directions [H, W, 3]) of the camera, on the card
    (``render/camera.py generate_rays``)."""
    return _raygen(width, height, K_inv, D, pose, inv_pose, exact, host=False)


def generate_rays_host(width: int, height: int, K_inv, D, pose, inv_pose, exact: bool = True):
    """S1's per-pixel code built for the host, on CPU tensors."""
    return _raygen(width, height, K_inv, D, pose, inv_pose, exact, host=True)


# ---------------------------------------------------------------------------
# S2 hit attributes
# ---------------------------------------------------------------------------


def attr_tables(scene) -> list:
    """S2's scene tables in ``frame_attrs_launch``'s order, checked:
    triangle corners, normals and uv corners, vertex normals (or None),
    triangle materials, the instance rows and materials."""
    T, I = scene.num_triangles, scene.num_instances
    f = lambda name, tail: _tensor(name, getattr(scene, name), torch.float32, (T,) + tail)
    tables = [f("tri_v0", (3,)), f("tri_v1", (3,)), f("tri_v2", (3,)), f("tri_normal", (3,)),
              f("tri_uv0", (2,)), f("tri_uv1", (2,)), f("tri_uv2", (2,)),
              None if scene.tri_vnorm is None else f("tri_vnorm", (10,)),
              _tensor("tri_mat", scene.tri_mat, torch.int32, (T,))]
    for name, width in (("inst_pose", 6), ("inst_inv_pose", 6), ("inst_scale", 3),
                        ("inst_inv_scale", 3)):
        tables.append(_tensor(name, getattr(scene, name), torch.float32, (I, width)))
    tables.append(_tensor("inst_material", scene.inst_material, torch.int32, (I,)))
    return tables


def _attributes(scene, origin, directions, hit, exact: bool, normal_mode: str, host: bool):
    from ..render.renderer import HitAttributes

    if normal_mode not in NORMAL_MODES:
        raise ValueError(f"unknown normal_mode {normal_mode!r}; one of {tuple(NORMAL_MODES)}")
    if not isinstance(directions, torch.Tensor) or directions.shape[-1:] != (3,):
        raise ValueError("directions must be a [..., 3] tensor")
    directions = _tensor("directions", directions, torch.float32)
    shape = directions.shape[:-1]
    dev = directions.device
    origin = _tensor("origin", origin, torch.float32)
    if origin.shape == (3,):
        stride = 0
    else:
        origin = origin.expand(directions.shape).contiguous()
        stride = 3
    t = _tensor("hit.t", hit.t, torch.float32, shape)
    tri = _tensor("hit.tri", hit.tri, torch.int32, shape)
    inst = _tensor("hit.inst", hit.inst, torch.int32, shape)
    if (hit.u is None) != (hit.v is None):
        raise ValueError("hit.u and hit.v are carried together")
    u = None if hit.u is None else _tensor("hit.u", hit.u, torch.float32, shape)
    v = None if hit.v is None else _tensor("hit.v", hit.v, torch.float32, shape)
    n = None if hit.n is None else _tensor("hit.n", hit.n, torch.float32, directions.shape)
    tables = attr_tables(scene)
    _same_device(dev, origin=origin, t=t, tri=tri, inst=inst, u=u, v=v, n=n,
                 scene=scene.tri_v0)
    run = _entry(dev, host, "attrs", "S2")
    r = t.numel()
    out_hit = torch.empty(shape, dtype=torch.bool, device=dev)
    location = torch.empty(directions.shape, dtype=torch.float32, device=dev)
    normal = torch.empty(directions.shape, dtype=torch.float32, device=dev)
    uv = torch.empty(shape + (2,), dtype=torch.float32, device=dev)
    material = torch.empty(shape, dtype=torch.int64, device=dev)
    out_inst = torch.empty(shape, dtype=torch.int64, device=dev)
    if r > 0:
        run(*map(_ptr, tables), scene.num_instances, origin.data_ptr(), stride,
            directions.data_ptr(), r, t.data_ptr(), tri.data_ptr(), inst.data_ptr(), _ptr(u),
            _ptr(v), _ptr(n), int(exact), NORMAL_MODES[normal_mode], out_hit.data_ptr(),
            location.data_ptr(), normal.data_ptr(), uv.data_ptr(), material.data_ptr(),
            out_inst.data_ptr())
    return HitAttributes(hit=out_hit, t=hit.t, location=location, normal=normal, uv=uv,
                         material=material, inst=out_inst)


def hit_attributes_cuda(scene, origin, directions, hit, exact: bool = True,
                        normal_mode: str = "reference"):
    """S2: ``HitAttributes`` of the hit record, on the card
    (``render/renderer.py hit_attributes``); ``t`` is ``hit.t`` itself."""
    return _attributes(scene, origin, directions, hit, exact, normal_mode, host=False)


def hit_attributes_host(scene, origin, directions, hit, exact: bool = True,
                        normal_mode: str = "reference"):
    """S2's per-ray code built for the host, on CPU tensors."""
    return _attributes(scene, origin, directions, hit, exact, normal_mode, host=True)


# ---------------------------------------------------------------------------
# S3 primary shade
# ---------------------------------------------------------------------------


def _material_tables(scene, has_sky: bool) -> tuple:
    """The leading arguments of S3's and S5's launchers, checked: the
    material tables, their mip levels, the texture atlas and its size,
    ``textured``, the sky map's start, width and height (None unless
    ``has_sky``) and ``has_sky``; and {name: tensor} of the tables whose
    device the caller checks."""
    tables = [_tensor("mat_albedo", scene.mat_albedo, torch.float32)]
    tables += [_tensor(k, getattr(scene, k), torch.int32)
               for k in ("mat_tex_start", "mat_tex_w", "mat_tex_h", "mat_tex_mip_start")]
    mips = tables[-1]
    if mips.dim() != 2 or mips.shape[0] != tables[0].shape[0] or mips.shape[1] < 1:
        raise ValueError(f"mat_tex_mip_start must be [K, levels], got {tuple(mips.shape)}")
    atlas = _tensor("tex_atlas", scene.tex_atlas, torch.int32)
    textured = bool(scene.has_textures)
    if textured and atlas.numel() == 0:
        raise ValueError("a textured scene needs a texture atlas")
    sky = [_tensor(k, getattr(scene, k), torch.int32, ()) if has_sky else None
           for k in ("sky_tex_start", "sky_tex_w", "sky_tex_h")]
    args = [*map(_ptr, tables), mips.shape[1], atlas.data_ptr(), atlas.numel(), int(textured),
            *map(_ptr, sky), int(has_sky)]
    return args, {"scene": tables[0], "sky": sky[0]}


def _shade(scene, attrs, light_direction, mode: str, exact: bool, directions, lit,
           point_lights, point_occ_t, tex_filter: str, host: bool):
    from ..core.vecmath import constant
    from ..render.shade import BLINN_SHININESS, BLINN_SPECULAR

    if mode not in MODES:
        raise ValueError(f"S3 shades the modes {tuple(MODES)}, got {mode!r}")
    if tex_filter not in FILTERS:
        raise ValueError(f"unknown texture filter: {tex_filter!r}")
    shape = attrs.hit.shape
    hit = _tensor("attrs.hit", attrs.hit, torch.bool)
    normal = _tensor("attrs.normal", attrs.normal, torch.float32, shape + (3,))
    uv = _tensor("attrs.uv", attrs.uv, torch.float32, shape + (2,))
    material = _tensor("attrs.material", attrs.material, torch.int64, shape)
    dev = hit.device
    has_light = mode != "flat" and light_direction is not None
    light = (0.0, 0.0, 0.0)
    if has_light:
        light = tuple(float(x) for x in light_direction)
        if len(light) != 3:
            raise ValueError(f"light_direction must have 3 components, got {light_direction!r}")
    if mode == "blinn_phong" and has_light and directions is None:
        raise ValueError("blinn_phong needs the ray directions")
    has_sky = bool(scene.has_sky) and directions is not None
    if (mode == "blinn_phong" and has_light) or has_sky:
        directions = _tensor("directions", directions, torch.float32, shape + (3,))
    else:
        directions = None
    if mode == "lambert_shadow" and has_light:
        if lit is None:
            raise ValueError("lambert_shadow needs the shadow rays' answer (lit)")
        lit = _tensor("lit", lit, torch.bool, shape)
    else:
        lit = None
    # trilinear takes its LOD from the screen derivatives of image rows
    height = width = 0
    inst = None
    if tex_filter == "trilinear" and len(shape) == 2:
        height, width = (int(x) for x in shape)
        inst = _tensor("attrs.inst", attrs.inst, torch.int64, shape)
    lights = location = None
    n_lights = len(point_lights) if mode != "flat" else 0
    shadows = n_lights > 0 and mode == "lambert_shadow"
    if n_lights:
        lights = constant([float(x) for pl in point_lights
                           for x in (*pl.position, pl.intensity)], torch.float32, dev)
        location = _tensor("attrs.location", attrs.location, torch.float32, shape + (3,))
    if shadows:
        if point_occ_t is None:
            raise ValueError("lambert_shadow with point lights needs their shadow rays' t "
                             "(point_occ_t)")
        point_occ_t = _tensor("point_occ_t", point_occ_t, torch.float32, (n_lights,) + shape)
    else:
        point_occ_t = None
    tables, scene_tensors = _material_tables(scene, has_sky)
    _same_device(dev, normal=normal, uv=uv, material=material, inst=inst, location=location,
                 directions=directions, lit=lit, point_occ_t=point_occ_t, **scene_tensors)
    run = _entry(dev, host, "shade", "S3")
    out = torch.empty(shape + (3,), dtype=torch.uint8, device=dev)
    r = hit.numel()
    if r > 0:
        run(*tables, hit.data_ptr(), normal.data_ptr(), uv.data_ptr(),
            material.data_ptr(), _ptr(inst), _ptr(location), _ptr(directions), _ptr(lit),
            _ptr(lights), _ptr(point_occ_t), r, MODES[mode], int(has_light), *light,
            int(exact), BLINN_SPECULAR, BLINN_SHININESS, FILTERS[tex_filter], height, width,
            n_lights, int(shadows), out.data_ptr())
    return out


def shade_primary_cuda(scene, attrs, light_direction, mode: str = "flat", exact: bool = True,
                       directions=None, lit=None, point_lights: tuple = (), point_occ_t=None,
                       tex_filter: str = "nearest") -> torch.Tensor:
    """S3: uint8 [..., 3] of the primary hits, on the card
    (``render/shade.py shade_primary``). The shadow rays' answers come in:
    ``lit`` (bool, Lambert with shadows and a directional light) where the
    ray toward the light escaped, ``point_occ_t`` ([L, ...] f32, Lambert
    with shadows and point lights) the t of each light's shadow ray."""
    return _shade(scene, attrs, light_direction, mode, exact, directions, lit, point_lights,
                  point_occ_t, tex_filter, host=False)


def shade_primary_host(scene, attrs, light_direction, mode: str = "flat", exact: bool = True,
                       directions=None, lit=None, point_lights: tuple = (), point_occ_t=None,
                       tex_filter: str = "nearest") -> torch.Tensor:
    """S3's per-ray code built for the host, on CPU tensors."""
    return _shade(scene, attrs, light_direction, mode, exact, directions, lit, point_lights,
                  point_occ_t, tex_filter, host=True)


# ---------------------------------------------------------------------------
# S4 sample
# ---------------------------------------------------------------------------


def _sample(key, chain, normal, exact: bool, lobe: bool, host: bool):
    chain = tuple(int(w) for w in chain)
    if len(chain) > MAX_CHAIN or any(not 0 <= w <= _WORD for w in chain):
        raise ValueError(f"the chain is at most {MAX_CHAIN} words of 32 bits, got {chain}")
    if not isinstance(normal, torch.Tensor) or normal.shape[-1:] != (3,):
        raise ValueError("normal must be a [..., 3] tensor")
    if normal.dtype != torch.float32:
        raise ValueError(f"normal must be torch.float32, got {normal.dtype}")
    key = _tensor("key", key, torch.int64, (2,))
    dev = normal.device
    _same_device(dev, key=key)
    run = _entry(dev, host, "sample", "S4")
    shape = normal.shape[:-1]
    dirs = torch.empty(normal.shape, dtype=torch.float32, device=dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev) if lobe else None
    r = dirs.numel() // 3
    if r > 0:
        # [outer, inner, 3]: a view wherever the layout allows one (a batch
        # expanded over its first axis keeps its stride of 0)
        outer = shape[0] if len(shape) >= 2 else 1
        n3 = normal.reshape(outer, r // outer, 3)
        words = chain + (0,) * (MAX_CHAIN - len(chain))
        run(key.data_ptr(), len(chain), *words, LOBE_WORD, n3.data_ptr(), n3.shape[1],
            *n3.stride(), r, int(exact), dirs.data_ptr(), _ptr(out))
    return (dirs, out) if lobe else dirs


def sample_cosine_cuda(key, chain, normal, exact: bool = True, lobe: bool = False):
    """S4: cosine-weighted directions [..., 3] around ``normal`` under the
    key ``key`` folded with each word of ``chain`` in turn, and with
    ``lobe`` also the uniforms [...] of that key folded with ``LOBE_WORD``,
    on the card (``render/integrators.py sample_cosine``)."""
    return _sample(key, chain, normal, exact, lobe, host=False)


def sample_cosine_host(key, chain, normal, exact: bool = True, lobe: bool = False):
    """S4's per-ray code built for the host, on CPU tensors."""
    return _sample(key, chain, normal, exact, lobe, host=True)


# ---------------------------------------------------------------------------
# S5 Whitted shade
# ---------------------------------------------------------------------------


def _bounce_state(state, directions) -> tuple:
    """(state, first) of a bounce of the rays ``directions`` [..., 3] that
    S5 or S6 updates in place: ``state`` (radiance [..., 3], throughput
    [..., 3], active [...]) checked, or, at the first bounce (None), made
    uninitialised, since the kernel starts from 0, 1 and true."""
    from .build import check_inputs

    shape, dev = directions.shape[:-1], directions.device
    first = state is None
    if first:
        state = (torch.empty(directions.shape, dtype=torch.float32, device=dev),
                 torch.empty(directions.shape, dtype=torch.float32, device=dev),
                 torch.empty(shape, dtype=torch.bool, device=dev))
    radiance, throughput, active = state
    # updated in place: no copy may stand in for them
    check_inputs(dev, ("radiance", radiance, torch.float32),
                 ("throughput", throughput, torch.float32), ("active", active, torch.bool))
    for name, x, want in (("radiance", radiance, directions.shape),
                          ("throughput", throughput, directions.shape),
                          ("active", active, shape)):
        if x.shape != want:
            raise ValueError(f"{name} must have shape {tuple(want)}, got {tuple(x.shape)}")
    return state, first


def _whitted_shade(scene, directions, attrs, illum, state, exact: bool, tex_filter: str,
                   last: bool, host: bool):
    if tex_filter not in FILTERS:
        raise ValueError(f"unknown texture filter: {tex_filter!r}")
    if not isinstance(directions, torch.Tensor) or directions.shape[-1:] != (3,):
        raise ValueError("directions must be a [..., 3] tensor")
    directions = _tensor("directions", directions, torch.float32)
    shape, dev = directions.shape[:-1], directions.device
    hit = _tensor("attrs.hit", attrs.hit, torch.bool, shape)
    location = _tensor("attrs.location", attrs.location, torch.float32, directions.shape)
    normal = _tensor("attrs.normal", attrs.normal, torch.float32, directions.shape)
    uv = _tensor("attrs.uv", attrs.uv, torch.float32, shape + (2,))
    material = _tensor("attrs.material", attrs.material, torch.int64, shape)
    illum = _tensor("illum", illum, torch.float32, shape)
    k = (scene.mat_albedo.shape[0],)
    refl = _tensor("mat_reflectivity", scene.mat_reflectivity, torch.float32, k)
    emit = _tensor("mat_illumination", scene.mat_illumination, torch.float32, k)
    tables, scene_tensors = _material_tables(scene, bool(scene.has_sky))
    state, first = _bounce_state(state, directions)
    radiance, throughput, active = state
    _same_device(dev, hit=hit, location=location, normal=normal, uv=uv, material=material,
                 illum=illum, mat_reflectivity=refl, mat_illumination=emit, **scene_tensors)
    run = _entry(dev, host, "whitted_shade", "S5")
    rays = None if last else (torch.empty(directions.shape, dtype=torch.float32, device=dev),
                              torch.empty(directions.shape, dtype=torch.float32, device=dev))
    r = hit.numel()
    if r > 0:
        run(*tables, refl.data_ptr(), emit.data_ptr(), directions.data_ptr(), hit.data_ptr(),
            location.data_ptr(), normal.data_ptr(), uv.data_ptr(), material.data_ptr(),
            illum.data_ptr(), r, FILTERS[tex_filter], int(exact), int(first), int(last),
            radiance.data_ptr(), throughput.data_ptr(), active.data_ptr(),
            *(_ptr(x) for x in rays or (None, None)))
    return state, rays


def whitted_shade_cuda(scene, directions, attrs, illum, state=None, exact: bool = True,
                       tex_filter: str = "nearest", last: bool = False):
    """S5: one Whitted bounce's shade on the card (``render/integrators.py
    whitted_shade``): ``state`` (radiance [..., 3], throughput [..., 3],
    active [...]) updated in place, or made at the first bounce (None), and
    the next bounce's rays (origins, directions), or None where ``last``:
    (state, rays)."""
    return _whitted_shade(scene, directions, attrs, illum, state, exact, tex_filter, last,
                          host=False)


def whitted_shade_host(scene, directions, attrs, illum, state=None, exact: bool = True,
                       tex_filter: str = "nearest", last: bool = False):
    """S5's per-ray code built for the host, on CPU tensors."""
    return _whitted_shade(scene, directions, attrs, illum, state, exact, tex_filter, last,
                          host=True)


# ---------------------------------------------------------------------------
# S6 path bounce
# ---------------------------------------------------------------------------


def _primary_rows(shape, fields) -> tuple:
    """``fields`` ((name, tensor, dtype, lanes), ...), each of shape
    ``shape + lanes``, checked, as (tensors, period): where every one is
    expanded over the first axis (stride 0, the batched wavefront's first
    bounce) its first row, read at ray r % period, else each contiguous
    (period: every ray)."""
    rays = 1
    for n in shape:
        rays *= int(n)
    for name, x, _, lanes in fields:
        if not isinstance(x, torch.Tensor) or tuple(x.shape) != tuple(shape) + lanes:
            got = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x).__name__
            raise ValueError(f"{name} must have shape {tuple(shape) + lanes}, got {got}")
    if len(shape) > 1 and shape[0] > 1 and all(x.stride(0) == 0 for _, x, _, _ in fields):
        return ([_tensor(name, x[0], dtype) for name, x, dtype, _ in fields],
                rays // int(shape[0]))
    return [_tensor(name, x, dtype) for name, x, dtype, _ in fields], rays


def _path_bounce(scene, directions, attrs, samples, illum, state, exact: bool, tex_filter: str,
                 sky_strength: float, light_scale: float, tail: bool, host: bool):
    if tex_filter not in FILTERS:
        raise ValueError(f"unknown texture filter: {tex_filter!r}")
    if not isinstance(directions, torch.Tensor) or directions.shape[-1:] != (3,):
        raise ValueError("directions must be a [..., 3] tensor")
    shape, dev = directions.shape[:-1], directions.device
    rows = [("directions", directions, torch.float32, (3,))]
    t = d_diff = lobe = None
    if tail:  # attrs is the any-hit cast's Hit
        t = _tensor("hit.t", attrs.t, torch.float32, shape)
    else:
        rows += [("attrs.hit", attrs.hit, torch.bool, ()),
                 ("attrs.location", attrs.location, torch.float32, (3,)),
                 ("attrs.normal", attrs.normal, torch.float32, (3,)),
                 ("attrs.uv", attrs.uv, torch.float32, (2,)),
                 ("attrs.material", attrs.material, torch.int64, ())]
        if samples is None:
            raise ValueError("a bounce needs S4's samples (directions, lobe uniforms)")
        d_diff = _tensor("d_diff", samples[0], torch.float32, directions.shape)
        lobe = _tensor("lobe", samples[1], torch.float32, shape)
    (dirs, *primary), period = _primary_rows(shape, rows)
    illum = None if illum is None or tail else _tensor("illum", illum, torch.float32, shape)
    k = (scene.mat_albedo.shape[0],)
    mats = [_tensor(name, getattr(scene, name), torch.float32, k)
            for name in ("mat_reflectivity", "mat_illumination", "mat_roughness")]
    tables, scene_tensors = _material_tables(scene, bool(scene.has_sky))
    state, first = _bounce_state(state, directions)
    radiance, throughput, active = state
    _same_device(dev, dirs=dirs, **dict(zip(("hit", "location", "normal", "uv", "material"),
                                            primary)),
                 t=t, d_diff=d_diff, lobe=lobe, illum=illum, mat_reflectivity=mats[0],
                 mat_illumination=mats[1], mat_roughness=mats[2], **scene_tensors)
    run = _entry(dev, host, "path_bounce", "S6")
    rays = None if tail else (torch.empty(directions.shape, dtype=torch.float32, device=dev),
                              torch.empty(directions.shape, dtype=torch.float32, device=dev))
    primary = primary or [None] * 5
    r = radiance.numel() // 3
    if r > 0:
        run(*tables, *map(_ptr, mats), dirs.data_ptr(), *map(_ptr, primary), period, _ptr(t),
            _ptr(d_diff), _ptr(lobe), _ptr(illum), r, FILTERS[tex_filter], int(exact),
            int(first), int(tail), float(sky_strength), float(light_scale), radiance.data_ptr(),
            throughput.data_ptr(), active.data_ptr(), *(_ptr(x) for x in rays or (None, None)))
    return state, rays


def path_bounce_cuda(scene, directions, attrs, samples=None, illum=None, state=None,
                     exact: bool = True, tex_filter: str = "nearest", sky_strength: float = 1.0,
                     light_scale: float = 0.0, tail: bool = False):
    """S6: one path-tracing bounce's ``bounce`` stage on the card
    (``render/integrators.py path_bounce``) on the rays ``directions`` and
    their hit attributes ``attrs``, S4's ``samples`` (cosine directions,
    lobe uniforms) and NEE's light term ``illum`` (None: NEE off, else
    weighted by ``light_scale``): ``state`` (radiance [..., 3], throughput
    [..., 3], active [...]) updated in place, or made at the first bounce
    (None), and the next bounce's rays (origins, directions): (state,
    rays). With ``tail`` the fast tail's sky term, ``attrs`` the any-hit
    cast's ``Hit``: (state, None)."""
    return _path_bounce(scene, directions, attrs, samples, illum, state, exact, tex_filter,
                        sky_strength, light_scale, tail, host=False)


def path_bounce_host(scene, directions, attrs, samples=None, illum=None, state=None,
                     exact: bool = True, tex_filter: str = "nearest", sky_strength: float = 1.0,
                     light_scale: float = 0.0, tail: bool = False):
    """S6's per-ray code built for the host, on CPU tensors."""
    return _path_bounce(scene, directions, attrs, samples, illum, state, exact, tex_filter,
                        sky_strength, light_scale, tail, host=True)
