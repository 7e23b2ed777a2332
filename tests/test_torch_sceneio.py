"""The port's scene input and output against the JAX package's: OBJ files
and the native OBJ parser (``scene/objloader.py``, ``scene/native_obj.py``),
``SceneTensors.save``/``load`` and the JAX npz format, the compile cache
(``scene/cache.py``) and the BVH disk cache (``scene/mesh.py``), and PNG
textures (``utils/image.py decode_png``, ``Material.upload_texture``).

Everything here is exact: the parsers' arrays bit for bit, npz fields
equal in both directions, PNG pixels equal to PIL's and to OpenCV's
decode (``cv2.imread``, which the JAX package's ``upload_texture`` uses).
"""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import tpu_raytracer.scene as js
from tpu_raytracer.scene.objloader import _parse_obj_py as jax_parse_obj
from tpu_raytracer.scene.scene import SceneArrays
from tpu_raytracer_torch.app.scenes import build_demo_scene
from tpu_raytracer_torch.scene import cache, mesh, native_obj, objloader, procgen
from tpu_raytracer_torch.scene.scene import ARRAY_FIELDS, SceneTensors
from tpu_raytracer_torch.utils.image import decode_png, read_png

from test_torch_gpu import encode_png
from test_torch_lights import vn_obj, vn_scenes
from test_torch_scene import compiled, jax_fields

torch.set_num_threads(1)

# the cases of tests/test_native_obj.py
OBJ_CASES = {
    "cube": procgen.cube_obj,
    "mixed_tokens": lambda: (
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "f 1/1 2/2 3/3\n"
        "f 2 3 4\n"
        "f 1/1 2 3/3\n"
    ),
    "quad_fan": lambda: (
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\n"
    ),
    "negative_indices": lambda: "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf -1 -2 -3\n",
    "v_vt_vn_syntax": lambda: (
        "v 0 0 0\nv 2 0 0\nv 0 2 0\n"
        "vt 0.5 0.25\nvt 1 0\nvt 0 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1\n"
    ),
    "floats": lambda: "v 1e-3 -2.5E2 +0.125\nv .5 -0.0 3\nv 1 2 3\nf 1 2 3\n",
    "cr_and_crlf_lines": lambda: "v 0 0 0\rv 1 0 0\r\nv 0 1 0\rf 1 2 3\r",
    "vertex_normals": vn_obj,
    "empty": lambda: "# nothing\n",
}
MALFORMED = {
    "bad_float": "v 1 2 x\nf 1 2 3\n",
    "empty_vertex_index": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf /1 2 3\n",
    "hex_float": "v 0x1 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
}


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("name", sorted(OBJ_CASES))
def test_parsers_match_jax_bit_for_bit(name, native):
    text = OBJ_CASES[name]()
    want = jax_parse_obj(text)
    got = objloader.parse_obj(text, native=native)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_parsers_reject_malformed_input_as_jax_does(name, native):
    text = MALFORMED[name]
    with pytest.raises(ValueError):
        jax_parse_obj(text)
    with pytest.raises(ValueError):
        objloader.parse_obj(text, native=native)


def test_parsers_reject_an_index_out_of_range():
    text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 9\n"
    with pytest.raises(IndexError):
        objloader.parse_obj(text, native=False)
    with pytest.raises(ValueError, match="out of range"):
        objloader.parse_obj(text, native=True)


def test_parse_obj_routes_large_texts_to_the_native_parser(monkeypatch):
    calls = []
    real = native_obj.parse_obj_native
    monkeypatch.setattr(native_obj, "parse_obj_native", lambda t: calls.append(t) or real(t))
    small = procgen.cube_obj()
    big = small + "#" * objloader.NATIVE_OBJ_THRESHOLD
    objloader.parse_obj(small)
    assert not calls
    for g, w in zip(objloader.parse_obj(big), jax_parse_obj(small)):
        np.testing.assert_array_equal(g, w)
    assert calls == [big]
    objloader.parse_obj(big, native=False)
    assert len(calls) == 1


def test_load_from_a_file_equals_jax_and_a_missing_file_raises(tmp_path, capsys):
    fp = tmp_path / "icosphere.obj"
    fp.write_text(vn_obj())
    got = objloader.load(str(fp), vertex_normals=True)
    want = js.objloader.load(str(fp), vertex_normals=True)
    for f in ("v0", "v1", "v2", "normal", "uv0", "uv1", "uv2", "vn0", "vn1", "vn2", "vn_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    q = objloader.load(str(fp), exact_normals=False)
    np.testing.assert_array_equal(q.normal, js.objloader.load(str(fp), exact_normals=False).normal)
    assert f"Loaded {got.num_triangles} triangles" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        objloader.load(str(tmp_path / "missing.obj"))


def _assert_fields(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_scenes():
    demo = build_demo_scene()
    demo.set_sky(procgen.sky_gradient_texture(32, 16))
    return {"demo_with_sky": demo.compile("cpu"), "vertex_normals": vn_scenes()[1],
            "two_instance": compiled("two_instance", "torch")[0]}


@pytest.mark.parametrize("name", ["demo_with_sky", "vertex_normals", "two_instance"])
def test_save_load_round_trip(tmp_path, name):
    scene = _port_scenes()[name]
    fp = str(tmp_path / "scene.npz")
    scene.save(fp)
    with np.load(fp) as data:
        keys = set(data.files)
    assert keys == set(ARRAY_FIELDS) | ({"tri_vnorm"} if scene.tri_vnorm is not None else set())
    back = SceneTensors.load(fp, device="cpu")
    _assert_fields(back.numpy_fields(), scene.numpy_fields())
    for flag in ("has_sky", "has_textures", "has_emissive"):
        assert getattr(back, flag) == getattr(scene, flag)
    for table in ("wide4", "binary", "tlas"):
        assert (getattr(back, table) is None) == (getattr(scene, table) is None), table
    for a, b in ((back.wide4.wnode, scene.wide4.wnode), (back.binary.node, scene.binary.node)):
        assert a.view(torch.int32).equal(b.view(torch.int32))  # NaN lanes too


def test_jax_saved_npz_loads_in_the_port_and_back(tmp_path):
    ja, pa = vn_scenes()
    fp = str(tmp_path / "jax.npz")
    ja.save(fp)
    got = SceneTensors.load(fp, device="cpu")
    _assert_fields(got.numpy_fields(), {**jax_fields(ja), "tri_vnorm": np.asarray(ja.tri_vnorm)})
    fp2 = str(tmp_path / "port.npz")
    pa.save(fp2)
    back = SceneArrays.load(fp2)
    _assert_fields({**jax_fields(back), "tri_vnorm": np.asarray(back.tri_vnorm)},
                   pa.numpy_fields())
    assert (back.has_sky, back.has_textures, back.has_emissive) == (
        pa.has_sky, pa.has_textures, pa.has_emissive)


def test_a_pre_mip_pre_sky_npz_takes_the_defaults(tmp_path):
    scene = compiled("cube", "torch")[0]
    fields = scene.numpy_fields()
    for k in ("mat_tex_mip_start", "sky_tex_start", "sky_tex_w", "sky_tex_h"):
        fields.pop(k)
    fp = str(tmp_path / "old.npz")
    np.savez(fp, **fields)
    got = SceneTensors.load(fp, device="cpu")
    np.testing.assert_array_equal(got.mat_tex_mip_start.numpy(), fields["mat_tex_start"][:, None])
    assert int(got.sky_tex_start) == -1 and not got.has_sky


def _small_scene():
    scene = build_demo_scene()
    scene.set_sky(procgen.sky_gradient_texture(16, 8))
    return scene


def test_compile_cached_cold_warm_and_corrupt(tmp_path, monkeypatch):
    scene = _small_scene()
    cold = cache.compile_cached(scene, str(tmp_path), device="cpu")
    entries = list(tmp_path.glob("scene_*.npz"))
    assert len(entries) == 1 and not list(tmp_path.glob("*.tmp.*"))

    def no_compile(*a, **k):
        raise AssertionError("compiled on a cache hit")

    with monkeypatch.context() as m:
        m.setattr(type(scene), "compile", no_compile)
        warm = cache.compile_cached(scene, str(tmp_path), device="cpu")
    _assert_fields(warm.numpy_fields(), cold.numpy_fields())
    entries[0].write_bytes(b"not an npz")
    again = cache.compile_cached(scene, str(tmp_path), device="cpu")
    _assert_fields(again.numpy_fields(), cold.numpy_fields())
    with np.load(entries[0]) as data:  # replaced by a good entry
        assert "tri_v0" in data.files
    # any change to what shapes the compile changes the key
    other = _small_scene()
    other.materials[0].albedo = (0.1, 0.2, 0.3)
    assert cache.scene_fingerprint(other) != cache.scene_fingerprint(scene)
    other = _small_scene()
    other.mesh_instances[1].pose = other.mesh_instances[1].pose + np.float32(1e-3)
    assert cache.scene_fingerprint(other) != cache.scene_fingerprint(scene)
    assert cache.scene_fingerprint(_small_scene()) == cache.scene_fingerprint(scene)


def test_bvh_cache_hit_corrupt_entry_and_off(tmp_path, monkeypatch):
    monkeypatch.setattr(mesh, "CACHE_MIN_TRIS", 1000)
    v = procgen.colonnade(3, 3, 8, bands=8)
    builds = []
    real = mesh._build_tree
    monkeypatch.setattr(mesh, "_build_tree", lambda *a: builds.append(1) or real(*a))
    d = str(tmp_path / "bvh")
    kw = dict(presplit=0.3, opt_rounds=1, cache_dir=d)
    cold = mesh.MeshPrimitive.from_triangles(*v, **kw)
    (entry,) = os.listdir(d)
    warm = mesh.MeshPrimitive.from_triangles(*v, **kw)
    assert len(builds) == 1
    for f in ("node_min", "node_max", "child_a", "child_b", "leaf_start", "leaf_count", "order"):
        np.testing.assert_array_equal(getattr(warm.bvh, f), getattr(cold.bvh, f))
    np.testing.assert_array_equal(warm.v0, cold.v0)
    # other options make another entry
    mesh.MeshPrimitive.from_triangles(*v, cache_dir=d)
    assert len(builds) == 2 and len(os.listdir(d)) == 2
    with open(os.path.join(d, entry), "r+b") as f:  # truncate: a corrupt entry
        f.truncate(100)
    again = mesh.MeshPrimitive.from_triangles(*v, **kw)
    assert len(builds) == 3
    np.testing.assert_array_equal(again.bvh.order, cold.bvh.order)
    np.load(os.path.join(d, entry)).close()
    off = str(tmp_path / "off")
    monkeypatch.setattr(mesh, "default_cache_dir", lambda: off)
    mesh.MeshPrimitive.from_triangles(*v, presplit=0.3, opt_rounds=1, cache_dir=False)
    assert len(builds) == 4 and not os.path.exists(off)
    monkeypatch.setattr(mesh, "CACHE_MIN_TRIS", len(v[0]) + 1)  # below the size: no file
    mesh.MeshPrimitive.from_triangles(*v, opt_rounds=2, cache_dir=d)
    assert len(os.listdir(d)) == 2


# --- PNG ------------------------------------------------------------------

COLOR_TYPES = {"greyscale": (0, 1), "rgb": (2, 3), "palette": (3, 1), "rgba": (6, 4)}
FILTER_SETS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
               "all_five": [0, 1, 2, 3, 4]}


def _image(color, seed=0, shape=(23, 31)):
    rng = np.random.default_rng(seed)
    ctype, ch = COLOR_TYPES[color]
    # smooth gradients plus noise, so the filters have something to predict
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    base = (x * 7 + y * 3)[..., None] + rng.integers(0, 40, shape + (ch,))
    img = (base % 256).astype(np.uint8)
    palette = None
    if color == "palette":
        img = (img % 50).astype(np.uint8)
        palette = rng.integers(0, 256, (50, 3))
    return (img if ch > 1 else img[..., 0]), ctype, palette


@pytest.mark.parametrize("filters", sorted(FILTER_SETS))
@pytest.mark.parametrize("color", sorted(COLOR_TYPES))
def test_decode_png_matches_pil_and_opencv(color, filters):
    import cv2

    img, ctype, palette = _image(color)
    data = encode_png(img if img.ndim == 3 else img[..., None], ctype, FILTER_SETS[filters],
                      palette)
    got = decode_png(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cv2.imdecode(np.frombuffer(data, np.uint8),
                                                    cv2.IMREAD_COLOR))


def test_decode_png_reads_pil_written_files():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (40, 33, 3), np.uint8)
    for mode in ("RGB", "L", "RGBA", "P"):
        im = Image.fromarray(img).convert(mode)
        buf = io.BytesIO()
        im.save(buf, "PNG")
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))[..., ::-1]
        np.testing.assert_array_equal(decode_png(buf.getvalue()), want)


def _pil_bytes(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["jpeg", "16_bit", "interlaced", "greyscale_alpha",
                                  "2_bit_palette", "not_an_image", "bad_crc"])
def test_decode_png_rejects_other_formats_by_name(case):
    img = np.zeros((8, 8, 3), np.uint8)
    data, match = {
        "jpeg": (lambda: _pil_bytes(Image.fromarray(img), "JPEG"), "JPEG"),
        "16_bit": (lambda: _pil_bytes(Image.fromarray(np.zeros((8, 8), np.uint16)), "PNG"),
                   "16-bit"),
        "interlaced": (lambda: encode_png(img, 2, [0], interlace=1), "interlaced"),
        "greyscale_alpha": (lambda: _pil_bytes(Image.fromarray(img).convert("LA"), "PNG"),
                            "greyscale with alpha"),
        "2_bit_palette": (lambda: encode_png(img[..., :1], 3, [0], np.zeros((4, 3)), depth=2),
                          "2-bit palette"),
        "not_an_image": (lambda: b"hello world", "not a PNG"),
        "bad_crc": (lambda: encode_png(img, 2, [0])[:-5] + b"\0" * 5, "corrupt"),
    }[case]
    with pytest.raises(ValueError, match=match):
        decode_png(data())


def test_upload_texture_gives_the_jax_packages_atlas(tmp_path, monkeypatch):
    """The port's atlas equals the JAX package's, with the port reading
    the files through ``cv2.imread`` and again through ``decode_png``
    (OpenCV blocked)."""
    fp = str(tmp_path / "checker.png")
    tex = procgen.checkerboard_texture(64, 8)
    img, ctype, palette = _image("rgb", seed=5, shape=(48, 40))
    other = str(tmp_path / "noise.png")
    with open(other, "wb") as f:
        f.write(encode_png(img, ctype, FILTER_SETS["all_five"]))
    with open(fp, "wb") as f:
        f.write(encode_png(tex[..., ::-1].copy(), 2, [4]))  # the file holds RGB
    np.testing.assert_array_equal(read_png(fp), tex)
    port = __import__("tpu_raytracer_torch.scene", fromlist=["Scene"])
    scenes = []
    for S, opencv in ((js, True), (port, True), (port, False)):
        scene = S.Scene()
        with monkeypatch.context() as m:
            if not opencv:
                m.setitem(sys.modules, "cv2", None)
            for path in (fp, other):
                mat = S.Material()
                mat.upload_texture(path)
                scene.add_material(mat)
        scene.add_mesh(S.objloader.loads(S.procgen.cube_obj()))
        scene.add_mesh_instance(S.MeshInstance(0, 1))
        scenes.append(scene)
    ja = scenes[0].compile()
    for ported in scenes[1:]:
        for mj, mp in zip(scenes[0].materials, ported.materials):
            np.testing.assert_array_equal(mp.texture, mj.texture)
        pa = ported.compile("cpu")
        for k in ("tex_atlas", "mat_tex_start", "mat_tex_w", "mat_tex_h", "mat_tex_mip_start"):
            np.testing.assert_array_equal(getattr(pa, k).numpy(), np.asarray(getattr(ja, k)),
                                          err_msg=k)
    with pytest.raises(FileNotFoundError):
        scenes[1].materials[0].upload_texture(str(tmp_path / "missing.png"))


def test_upload_texture_reads_what_opencv_reads(tmp_path, monkeypatch):
    """A JPEG and a 16-bit PNG written by OpenCV: with OpenCV the port's
    ``read_png`` is ``cv2.imread`` as the JAX package's
    ``upload_texture``, and both packages build the same texture atlas
    (exact); with OpenCV blocked the numpy decoder refuses both files,
    naming the format."""
    import cv2

    img = np.random.default_rng(8).integers(0, 256, (24, 40, 3), np.uint8)
    files = {"jpeg": str(tmp_path / "t.jpg"), "16_bit": str(tmp_path / "t16.png")}
    assert cv2.imwrite(files["jpeg"], img)
    assert cv2.imwrite(files["16_bit"], img.astype(np.uint16) * 257)
    scenes = []
    for S in (js, __import__("tpu_raytracer_torch.scene", fromlist=["Scene"])):
        scene = S.Scene()
        for fp in files.values():
            mat = S.Material()
            mat.upload_texture(fp)
            scene.add_material(mat)
        scene.add_mesh(S.objloader.loads(S.procgen.cube_obj()))
        scene.add_mesh_instance(S.MeshInstance(0, 1))
        scenes.append(scene)
    np.testing.assert_array_equal(read_png(files["16_bit"]), img)  # 16 bits down to 8
    np.testing.assert_array_equal(read_png(files["jpeg"]), cv2.imread(files["jpeg"]))
    ja, pa = scenes[0].compile(), scenes[1].compile("cpu")
    for k in ("tex_atlas", "mat_tex_start", "mat_tex_w", "mat_tex_h", "mat_tex_mip_start"):
        np.testing.assert_array_equal(getattr(pa, k).numpy(), np.asarray(getattr(ja, k)), err_msg=k)
    with pytest.raises(ValueError, match="OpenCV cannot read"):
        (tmp_path / "junk.png").write_bytes(b"not an image")
        read_png(str(tmp_path / "junk.png"))

    monkeypatch.setitem(sys.modules, "cv2", None)
    for fmt, match in (("jpeg", "JPEG"), ("16_bit", "16-bit")):
        with pytest.raises(ValueError, match=match):
            read_png(files[fmt])
        with pytest.raises(ValueError, match=match):
            scenes[1].materials[0].upload_texture(files[fmt])
    with pytest.raises(FileNotFoundError):
        read_png(str(tmp_path / "missing.png"))
