"""``"entry": "whitted"``: Whitted frames through
``compiled_render_image_whitted`` with the traffic's ``max_bounces`` and
``shadows``; the plain Whitted reference (``reference_whitted.py``)."""

from rtbench import reference_whitted

KEYED = False
COMPILED = "compiled_render_image_whitted"


def bind(pipeline, scene, cfg, traffic):
    entry = pipeline.compiled_render_image_whitted
    static = (traffic["max_bounces"], traffic["shadows"])

    def frame(K_inv, D, pose, inv_pose, key):
        return entry(cfg, scene, K_inv, D, pose, inv_pose, *static)

    return frame


def reference(ref, rays, key, config, traffic):
    return reference_whitted.whitted(ref, rays, traffic["max_bounces"], traffic["shadows"])
