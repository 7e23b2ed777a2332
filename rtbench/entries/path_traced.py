"""``"entry": "path_traced"``: path-traced frames through
``compiled_render_image_path_traced`` with the traffic's ``max_bounces``
and ``samples``, keyed by the frame; the reference's ``path_traced``."""

from rtbench import reference as plain

KEYED = True
COMPILED = "compiled_render_image_path_traced"


def bind(pipeline, scene, cfg, traffic):
    entry = pipeline.compiled_render_image_path_traced
    static = (traffic["max_bounces"], traffic["samples"])

    def frame(K_inv, D, pose, inv_pose, key):
        return entry(cfg, scene, K_inv, D, pose, inv_pose, key, *static)

    return frame


def reference(ref, rays, key, config, traffic):
    return plain.path_traced(ref.geom, rays, key, tuple(config["albedo"]), traffic["samples"],
                             traffic["max_bounces"])
