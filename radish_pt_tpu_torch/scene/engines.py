"""The intersection engines: one record each, and the one place that
resolves an engine's name (``DeviceScene.intersector``).

``plucker`` (accel/plucker.py; the default up to 131,072 triangles),
``compact`` (accel/compact.py; the default above), ``quad``
(accel/quad.py), ``band`` (accel/band.py; above 1,024 triangles),
``dense`` (accel/dense.py) and ``bvh`` (accel/traverse.py's MTBVH walk)
launch their CUDA kernels on the card and run their plain versions on the
CPU; ``brute`` (accel/traverse.py) is the exhaustive Möller–Trumbore
oracle in torch.  Each but ``dense`` has a plain twin, ``<name>_plain``,
that runs it, its sort key and its heatmap walk in plain torch on any
device; ``dense``'s is ``brute``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from ..accel import band as bnd
from ..accel import compact as cpt
from ..accel import dense as dns
from ..accel import plucker as plk
from ..accel import quad as qd
from ..accel import traverse as trv


@dataclass(frozen=True)
class Engine:
    """One engine under one name."""

    name: str
    # (ds, ray_o, ray_d, active) -> (prim i32 [N], bary f32 [N, 2] | None);
    # ``active`` False marks a dead lane (None: all live)
    closest_hit: Callable
    occlusion: Callable  # (ds, x, y) -> bool [N]: segment x->y blocked
    plain_twin: str  # the name that runs it in plain torch on any device
    plain: bool = False  # this name is a plain twin
    # positional winners, full frames in tile order, primaries sorted
    sweep: bool = False
    capturable: bool = False  # no host sync in a frame: blocks are CUDA graphs
    fixed_clusters: bool = False  # stored in 64-triangle clusters
    # lanes that share a culling decision: "warp" (32), "row" (128) or
    # "band" (128 / band_g, with a count-major sort key); None: no cull
    group: str | None = None
    # the eager culling before its sweeps: "rows" (the row-mask prepass
    # before a closest hit), "work list" (before every sweep; it reads its
    # length on the host and needs clusters on every scene); None: none
    prepass: str | None = None
    forms: bool = False  # reads the quadratic forms, built for it alone


def _range(active):
    """A lane's range: FLT_MAX live, -FLT_MAX dead (None: no range)."""
    return None if active is None else torch.where(active, trv.FLT_MAX, -trv.FLT_MAX)


def _plucker_hit(ds, o, d, active, plain=False):
    return plk.intersect_plucker(ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds,
                                 ds.cluster_sub, o, d, tmax=_range(active), plain=plain,
                                 packed=ds.sweep_packed)[0], None


def _plucker_occl(ds, x, y, plain=False):
    return plk.occlusion_plucker(ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds,
                                 ds.cluster_sub, x, y, plain=plain, packed=ds.sweep_packed)


def _compact_hit(ds, o, d, active, plain=False):
    return cpt.intersect_compact(ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds, o, d,
                                 tmax=_range(active), plain=plain, packed=ds.sweep_packed,
                                 spheres=ds.unit_spheres)[0], None


def _compact_occl(ds, x, y, plain=False):
    return cpt.occlusion_compact(ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds, x, y,
                                 plain=plain, packed=ds.sweep_packed, spheres=ds.unit_spheres)


def _quad_hit(ds, o, d, active, plain=False):
    return qd.intersect_quad(ds.quad_coeffs, ds.sweep_center, ds.cluster_bounds,
                             ds.cluster_sub, o, d, tmax=_range(active), plain=plain,
                             packed=ds.quad_packed)[0], None


def _quad_occl(ds, x, y, plain=False):
    return qd.occlusion_quad(ds.quad_coeffs, ds.sweep_center, ds.cluster_bounds,
                             ds.cluster_sub, x, y, plain=plain, packed=ds.quad_occl_packed)


def _band_hit(ds, o, d, active, plain=False):
    return bnd.intersect_band(ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds, ds.band_g,
                              o, d, tmax=_range(active), plain=plain, packed=ds.sweep_packed,
                              words_box=ds.word_bounds)[0], None


def _band_occl(ds, x, y, plain=False):
    return bnd.occlusion_band(ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds, ds.band_g,
                              x, y, plain=plain, packed=ds.sweep_packed,
                              words_box=ds.word_bounds)


def _dense_hit(ds, o, d, active):
    prim, _, bary = dns.intersect_dense(ds.tri_packed, o, d)
    return prim, bary


def _dense_occl(ds, x, y):
    return dns.occlusion_dense(ds.tri_packed, x, y)


def _bvh_hit(ds, o, d, active, plain=False):
    prim, _, bary = trv.intersect_bvh(ds.leaf_tris, ds.leaf_map, ds.bvh_packed, o, d,
                                      _range(active), plain=plain)
    return prim, bary


def _bvh_occl(ds, x, y, plain=False):
    return trv.occlusion_bvh(ds.leaf_tris, ds.bvh_packed, x, y, plain=plain)


def _brute_hit(ds, o, d, active):
    prim, _, bary = trv.intersect_brute(ds.tri_packed, o, d)
    return prim, bary


def _brute_occl(ds, x, y):
    return trv.occlusion_brute(ds.tri_packed, x, y)


_SWEEP = dict(sweep=True, group="warp")
_BASE = (
    Engine("plucker", _plucker_hit, _plucker_occl, "plucker_plain", capturable=True, **_SWEEP),
    Engine("compact", _compact_hit, _compact_occl, "compact_plain", fixed_clusters=True,
           prepass="work list", **_SWEEP),
    Engine("quad", _quad_hit, _quad_occl, "quad_plain", capturable=True, sweep=True,
           group="row", prepass="rows", forms=True),
    Engine("band", _band_hit, _band_occl, "band_plain", capturable=True, fixed_clusters=True,
           sweep=True, group="band"),
    Engine("dense", _dense_hit, _dense_occl, "brute", capturable=True),
    Engine("bvh", _bvh_hit, _bvh_occl, "bvh_plain", capturable=True, fixed_clusters=True),
    Engine("brute", _brute_hit, _brute_occl, "brute"),
)
# the names a scene is built with (load_scene, the command lines)
NAMES = tuple(e.name for e in _BASE)
ENGINES = {e.name: e for e in _BASE}
ENGINES.update({
    e.plain_twin: dataclasses.replace(
        e, name=e.plain_twin, plain=True, capturable=False,
        closest_hit=partial(e.closest_hit, plain=True),
        occlusion=partial(e.occlusion, plain=True))
    for e in _BASE if e.plain_twin not in ENGINES})


def get(name: str) -> Engine:
    """The engine of ``name`` (:data:`NAMES` or a plain twin's name)."""
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown intersector {name!r}") from None


def of(ds) -> Engine:
    """The engine of scene ``ds``."""
    return get(ds.intersector)
