"""load_scene_s: host clock around the port's ``load_scene``."""


def read(rec):
    return rec.get("load_scene_s")
