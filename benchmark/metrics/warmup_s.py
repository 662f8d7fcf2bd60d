"""warmup_s: host clock from the built ``Renderer`` to its first call's
block replayed (warm-up block, capture, replay) and synced."""


def read(rec):
    return rec.get("warmup_s")
