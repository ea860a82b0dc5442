"""setup.scene_build_s: host seconds of `block_traversal.build` in
set-up (the SAH block build and the scene's move to the card)."""


def read(run):
    return run.setup.get("scene_build_s")
