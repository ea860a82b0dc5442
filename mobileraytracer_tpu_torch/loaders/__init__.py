"""Scene-file loaders: OBJ/MTL scenes (native C++ parser), textures and
camera files."""
from .cam import load_camera_file  # noqa: F401
from .obj import load_obj_scene  # noqa: F401
