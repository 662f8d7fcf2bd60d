"""Scene-file parser — same text grammar as the reference
(``reference/src/scene.cpp:108-459``):

    Material <name>          # 6 lines: Type/BaseColor/Metallic/Roughness/Ior/NormalMap
    Object <name>            # line1: mesh path; line2: Material <name|Null>;
                             # then Translate/Rotate/Scale lines until blank
    Camera                   # 8 lines: Resolution/FovY/LensRadius/FocalDist/
                             # ApertureMask/Sample/Depth/File; then Eye/Rotation/Up
    EnvMap <path|Null>

A frozen copy of the port's ``scene/parser.py``; the result feeds
:func:`benchmark.reference.shading.build_scene`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .shading import MATERIAL_TYPE_TOKENS, NULL_TEXTURE, PROCEDURAL_TEXTURE
from .vmath import build_transformation_matrix
from .image_io import load_image
from .obj_loader import MeshData, load_obj


@dataclass
class RenderState:
    iterations: int = 64  # "Sample" in the scene file
    image_name: str = "render"


@dataclass
class Settings:
    trace_depth: int = 5
    scene_light_single_sided: bool = True


@dataclass
class HostMaterial:
    mtype: int = 0
    base_color: tuple = (0.9, 0.9, 0.9)
    metallic: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    color_map: int = NULL_TEXTURE
    normal_map: int = NULL_TEXTURE
    metallic_map: int = NULL_TEXTURE
    roughness_map: int = NULL_TEXTURE


@dataclass
class HostInstance:
    mesh: MeshData = None
    material_id: int = 0
    translation: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)

    @property
    def transform(self) -> np.ndarray:
        return build_transformation_matrix(self.translation, self.rotation, self.scale)


class Resource:
    """Memoized mesh & texture pools keyed by filename
    (reference ``Resource``, scene.cpp:25-106)."""

    mesh_pool: dict = {}
    texture_pool: dict = {}

    @classmethod
    def load_mesh(cls, path: str) -> MeshData:
        if path not in cls.mesh_pool:
            cls.mesh_pool[path] = load_obj(path)
        return cls.mesh_pool[path]

    @classmethod
    def load_texture(cls, path: str, flip_vertical: bool = True) -> np.ndarray:
        key = (path, flip_vertical)
        if key not in cls.texture_pool:
            cls.texture_pool[key] = load_image(path, flip_vertical=flip_vertical)
        return cls.texture_pool[key]

    @classmethod
    def clear(cls) -> None:
        cls.mesh_pool.clear()
        cls.texture_pool.clear()


@dataclass
class SceneDesc:
    """Parsed host scene; mirrors reference ``Scene`` members (scene.h:520-577)."""

    materials: list = field(default_factory=list)
    material_map: dict = field(default_factory=dict)
    instances: list = field(default_factory=list)
    textures: list = field(default_factory=list)  # np arrays [H,W,3] linear
    texture_map: dict = field(default_factory=dict)
    env_tex_id: int = NULL_TEXTURE
    aperture_tex_id: int = NULL_TEXTURE

    # camera
    width: int = 800
    height: int = 800
    fov_y: float = 45.0  # HALF vertical fov in degrees (reference convention)
    lens_radius: float = 0.0
    focal_dist: float = 1.0
    cam_position: tuple = (0.0, 0.0, 0.0)
    cam_rotation: tuple = (0.0, 0.0, 0.0)
    cam_up: tuple = (0.0, 1.0, 0.0)

    state: RenderState = field(default_factory=RenderState)
    settings: Settings = field(default_factory=Settings)
    base_dir: str = "."

    def add_texture(self, path: str, flip_vertical: bool = True) -> int:
        full = path if os.path.isabs(path) else os.path.join(self.base_dir, path)
        key = (full, flip_vertical)
        if key in self.texture_map:
            return self.texture_map[key]
        img = Resource.load_texture(full, flip_vertical=flip_vertical)
        tid = len(self.textures)
        self.textures.append(img)
        self.texture_map[key] = tid
        return tid


def _tokens(line: str) -> list[str]:
    return line.split()


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def parse_scene(path: str) -> SceneDesc:
    scene = SceneDesc()
    scene.base_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", encoding="utf-8") as f:
        lines = [ln.rstrip("\r\n") for ln in f]

    i = 0

    def next_line():
        nonlocal i
        ln = lines[i] if i < len(lines) else ""
        i += 1
        return ln

    while i < len(lines):
        line = next_line()
        if not line.strip():
            continue
        toks = _tokens(line)
        if toks[0] == "Material":
            _parse_material(scene, toks[1], next_line)
        elif toks[0] == "Object":
            _parse_object(scene, next_line)
        elif toks[0] == "Camera":
            _parse_camera(scene, next_line)
        elif toks[0] == "EnvMap":
            if toks[1] != "Null":
                # env maps are NOT flipped (scene.cpp:132-137)
                scene.env_tex_id = scene.add_texture(toks[1], flip_vertical=False)
    return scene


def _parse_material(scene: SceneDesc, name: str, next_line) -> None:
    mat = HostMaterial()
    for _ in range(6):
        toks = _tokens(next_line())
        if not toks:
            continue
        key = toks[0]
        if key == "Type":
            mat.mtype = MATERIAL_TYPE_TOKENS[toks[1]]
        elif key == "BaseColor":
            if len(toks) > 2:
                mat.base_color = (float(toks[1]), float(toks[2]), float(toks[3]))
            elif toks[1] == "Procedural":
                mat.color_map = PROCEDURAL_TEXTURE
            else:
                mat.color_map = scene.add_texture(toks[1])
        elif key == "Metallic":
            if _is_number(toks[1]):
                mat.metallic = float(toks[1])
            else:
                mat.metallic_map = scene.add_texture(toks[1])
        elif key == "Roughness":
            if _is_number(toks[1]):
                mat.roughness = float(toks[1])
            else:
                mat.roughness_map = scene.add_texture(toks[1])
        elif key == "Ior":
            mat.ior = float(toks[1])
        elif key == "NormalMap":
            if toks[1] != "Null":
                mat.normal_map = scene.add_texture(toks[1])
    scene.material_map[name] = len(scene.materials)
    scene.materials.append(mat)


def _parse_object(scene: SceneDesc, next_line) -> None:
    inst = HostInstance()
    mesh_path = next_line().strip()
    full = (
        mesh_path
        if os.path.isabs(mesh_path)
        else os.path.join(scene.base_dir, mesh_path)
    )
    inst.mesh = Resource.load_mesh(full)

    toks = _tokens(next_line())
    if toks and toks[0] == "Material":
        if toks[1] == "Null":
            inst.material_id = len(scene.materials)
            scene.materials.append(HostMaterial())
        else:
            if toks[1] not in scene.material_map:
                raise KeyError(f"Material {toks[1]!r} not found")
            inst.material_id = scene.material_map[toks[1]]

    line = next_line()
    while line.strip():
        toks = _tokens(line)
        if toks[0] == "Translate":
            inst.translation = (float(toks[1]), float(toks[2]), float(toks[3]))
        elif toks[0] == "Rotate":
            inst.rotation = (float(toks[1]), float(toks[2]), float(toks[3]))
        elif toks[0] == "Scale":
            inst.scale = (float(toks[1]), float(toks[2]), float(toks[3]))
        line = next_line()
    scene.instances.append(inst)


def _parse_camera(scene: SceneDesc, next_line) -> None:
    for _ in range(8):
        toks = _tokens(next_line())
        if not toks:
            continue
        key = toks[0]
        if key == "Resolution":
            scene.width, scene.height = int(toks[1]), int(toks[2])
        elif key == "FovY":
            scene.fov_y = float(toks[1])
        elif key == "LensRadius":
            scene.lens_radius = float(toks[1])
        elif key == "FocalDist":
            scene.focal_dist = float(toks[1])
        elif key == "ApertureMask":
            if toks[1] != "Null":
                scene.aperture_tex_id = scene.add_texture(toks[1])
        elif key == "Sample":
            scene.state.iterations = int(toks[1])
        elif key == "Depth":
            scene.settings.trace_depth = int(toks[1])
        elif key == "File":
            scene.state.image_name = toks[1]

    line = next_line()
    while line.strip():
        toks = _tokens(line)
        if toks[0] == "Eye":
            scene.cam_position = (float(toks[1]), float(toks[2]), float(toks[3]))
        elif toks[0] == "Rotation":
            scene.cam_rotation = (float(toks[1]), float(toks[2]), float(toks[3]))
        elif toks[0] == "Up":
            scene.cam_up = (float(toks[1]), float(toks[2]), float(toks[3]))
        try:
            line = next_line()
        except IndexError:
            break
