"""``"entry": "image"``: primary frames through ``compiled_render_image``
(``lighting`` from the traffic, default flat); the reference's
``primary`` with the configuration's albedo."""

from rtbench import reference as plain

KEYED = False
COMPILED = "compiled_render_image"


def bind(pipeline, scene, cfg, traffic):
    entry = pipeline.compiled_render_image

    def frame(K_inv, D, pose, inv_pose, key):
        return entry(cfg, scene, K_inv, D, pose, inv_pose)

    return frame


def reference(ref, rays, key, config, traffic):
    return plain.primary(ref.geom, rays, tuple(config["albedo"]), traffic.get("lighting", "flat"))
