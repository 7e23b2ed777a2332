"""``"entry": "ao"``: ambient-occlusion frames through
``compiled_render_image_ao`` with the traffic's ``samples`` and
``radius``, keyed by the frame; the reference's ``ambient_occlusion``."""

from rtbench import reference as plain

KEYED = True
COMPILED = "compiled_render_image_ao"


def bind(pipeline, scene, cfg, traffic):
    entry = pipeline.compiled_render_image_ao
    static = (traffic["samples"], traffic["radius"])

    def frame(K_inv, D, pose, inv_pose, key):
        return entry(cfg, scene, K_inv, D, pose, inv_pose, key, *static)

    return frame


def reference(ref, rays, key, config, traffic):
    return plain.ambient_occlusion(ref.geom, rays, key, traffic["samples"], traffic["radius"])
