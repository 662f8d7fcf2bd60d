"""Vector math of the plain reference renderer: a frozen copy of the
port's ``utils/math.py`` (itself a port of ``radish_pt_tpu/utils/math.py``): every function is a batched torch
function on tensors whose *last* axis holds the vector components, in the
same f32 operation order as the JAX reference so results agree to the ulp
(transcendentals may differ by an ulp between the two libraries).

Unsigned 32-bit arithmetic (``utilhash``) runs in int64 masked to 32 bits:
torch's ``uint32`` lacks most operators, and int64 holds every intermediate
of the hash exactly.

Constants the frame path needs as tensors come from :func:`const`, made
once per device: the frame then copies nothing from the host, which a
CUDA graph could not capture.

Host-side helpers (transform matrices) live at the bottom and use numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import precision as prec

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI

U32 = 0xFFFFFFFF
INV_2_32 = 2.0**-32  # exact in f32



@functools.lru_cache(maxsize=None)
def _const(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype, device)`` made once per (values,
    dtype, device) and shared: callers read it and never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype=None, device="cpu") -> torch.Tensor:
    """:func:`_const` in the reference's float type by default."""
    return _const(values, prec.FT if dtype is None else dtype, torch.device(device))


# ---------------------------------------------------------------------------
# small vector helpers (last-axis = xyz)
# ---------------------------------------------------------------------------


def dot(a, b):
    """Batched dot product over the last axis, keeps no dims."""
    return torch.sum(a * b, dim=-1)


def vdot(a, b):
    """Batched dot product, keepdims for broadcasting against vec3s."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    """a x b as separate multiplies and subtracts (no fused multiply-add,
    like the reference's ``jnp.cross``)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def length(a):
    return torch.sqrt(torch.clamp(torch.sum(a * a, dim=-1), min=0.0))


def normalize(a, eps: float = 1e-12):
    return a / torch.clamp(length(a), min=eps)[..., None]


def sat_dot(a, b):
    """max(dot(a, b), 0) — reference ``Math::satDot`` (mathUtil.h:67)."""
    return torch.clamp(dot(a, b), min=0.0)


def abs_dot(a, b):
    """|dot(a, b)| — reference ``Math::absDot`` (mathUtil.h:71)."""
    return torch.abs(dot(a, b))


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


# ---------------------------------------------------------------------------
# MIS heuristics (mathUtil.h:81-88)
# ---------------------------------------------------------------------------


def power_heuristic(f, g):
    f2 = f * f
    return f2 / (f2 + g * g)


# ---------------------------------------------------------------------------
# triangles (mathUtil.h:90-108)
# ---------------------------------------------------------------------------


def triangle_normal(v0, v1, v2):
    return normalize(cross(v1 - v0, v2 - v0))


def sample_triangle_uniform(v0, v1, v2, ru, rv):
    """Uniform point on a triangle; matches reference's sqrt warp
    (mathUtil.h:100-108): u = 1-sqrt(rv), v = ru*sqrt(rv)."""
    r = torch.sqrt(rv)
    u = 1.0 - r
    v = ru * r
    w = 1.0 - u - v
    return v1 * u[..., None] + v2 * v[..., None] + v0 * w[..., None]


# ---------------------------------------------------------------------------
# tone mapping / color (mathUtil.h:110-130)
# ---------------------------------------------------------------------------


def _calc_filmic(c):
    return (c * (c * 0.22 + 0.03) + 0.002) / (c * (c * 0.22 + 0.3) + 0.06) - 1.0 / 30.0


def filmic(c):
    """Uncharted-style filmic curve (mathUtil.h:110-116)."""
    white = _calc_filmic(const(11.2, device=c.device))
    return _calc_filmic(c * 1.6) / white


def aces(c):
    """ACES approximation (mathUtil.h:118-122)."""
    return (c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59) + 0.14)


def gamma_correction(c):
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def hdr_to_ldr(c):
    """Reinhard-style range compression c/(1+c) (mathUtil.h:49-51)."""
    return c / (c + 1.0)


# ---------------------------------------------------------------------------
# sampling warps (mathUtil.h:132-166)
# ---------------------------------------------------------------------------


def concentric_sample_disk(rx, ry):
    """Disk sample; reference uses the simple polar warp (mathUtil.h:132-136)."""
    r = torch.sqrt(rx)
    theta = TWO_PI * ry
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def to_sphere(v):
    """Equirect [0,1]^2 -> unit direction (mathUtil.h:138-142):
    v[..., 0] * 2pi is the azimuth, v[..., 1] * pi the polar angle from +Y."""
    phi = v[..., 0] * TWO_PI
    theta = v[..., 1] * PI
    sin_t = torch.sin(theta)
    return torch.stack(
        [torch.cos(phi) * sin_t, torch.cos(theta), torch.sin(phi) * sin_t], dim=-1)


def to_plane(v):
    """Unit direction -> equirect uv in [0,1]^2 (mathUtil.h:144-147): the
    azimuth from atan2(z, x), wrapped by mod(... + 1, 1), the polar angle
    from +Y."""
    u = torch.remainder(torch.atan2(v[..., 2], v[..., 0]) * INV_PI * 0.5 + 1.0, 1.0)
    w = torch.atan2(length(v[..., 0::2]), v[..., 1]) * INV_PI
    return torch.stack([u, w], dim=-1)


def local_ref_matrix(n):
    """Orthonormal frame with n as +Z; [..., 3, 3] where [..., i, :] is basis
    vector i (t, b, n).  Mirrors mathUtil.h:149-155."""
    z_up = const((0.0, 0.0, 1.0), n.dtype, n.device)
    y_up = const((0.0, 1.0, 0.0), n.dtype, n.device)
    up = torch.where((torch.abs(n[..., 1]) > 0.9999)[..., None], z_up, y_up)
    b = normalize(cross(n, up))
    t = cross(b, n)
    return torch.stack([t, b, n], dim=-2)


def local_to_world(n, v):
    """Transform local vec (z = n) to world and normalize (mathUtil.h:157-159)."""
    m = local_ref_matrix(n)
    return normalize(
        m[..., 0, :] * v[..., 0:1] + m[..., 1, :] * v[..., 1:2] + m[..., 2, :] * v[..., 2:3]
    )


def cosine_sample_hemisphere(n, rx, ry):
    d = concentric_sample_disk(rx, ry)
    z = torch.sqrt(torch.clamp(1.0 - torch.sum(d * d, dim=-1), min=0.0))
    v = torch.cat([d, z[..., None]], dim=-1)
    return local_to_world(n, v)


def refract(n, wi, ior):
    """Batched refraction (mathUtil.h:168-186).  Returns (wt, valid): the
    refracted direction and a bool mask (False on TIR)."""
    cos_in = dot(n, wi)
    eta = torch.where(cos_in < 0.0, 1.0 / ior, ior)
    sin2_in = torch.clamp(1.0 - cos_in * cos_in, min=0.0)
    sin2_tr = sin2_in / (eta * eta)
    valid = sin2_tr < 1.0
    cos_tr = torch.sqrt(torch.clamp(1.0 - sin2_tr, min=0.0))
    cos_tr = torch.where(cos_in < 0.0, -cos_tr, cos_tr)
    wt = normalize(-wi / eta[..., None] + n * (cos_in / eta - cos_tr)[..., None])
    return wt, valid


def fresnel(cos_in, ior):
    """Exact unpolarized dielectric Fresnel (material.h:44-64)."""
    eta = torch.where(cos_in < 0.0, 1.0 / ior, ior)
    ci = torch.abs(cos_in)
    sin_in = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_tr = sin_in / eta
    tir = sin_tr >= 1.0
    cos_tr = torch.sqrt(torch.clamp(1.0 - sin_tr * sin_tr, min=0.0))
    r_par = (ci - eta * cos_tr) / (ci + eta * cos_tr)
    r_per = (eta * ci - cos_tr) / (eta * ci + cos_tr)
    f = (r_par * r_par + r_per * r_per) * 0.5
    return torch.where(tir, torch.ones_like(f), f)


def fresnel_schlick(l_dot_h, f0):
    """Schlick approximation for a vec3 ``f0`` (material.h:35-42)."""
    t = pow5(torch.clamp(1.0 - l_dot_h, min=0.0))[..., None]
    return f0 + (1.0 - f0) * t


def pdf_area_to_solid_angle(pdf, x, y, ny):
    """Convert area-measure pdf at point y (normal ny) seen from x into a
    solid-angle pdf (mathUtil.h:188-192)."""
    yx = x - y
    dist2 = torch.sum(yx * yx, dim=-1)
    return pdf * dist2 / torch.clamp(abs_dot(ny, normalize(yx)), min=1e-12)


# ---------------------------------------------------------------------------
# integer hash (mathUtil.h:199-207) on int64 holding u32 values
# ---------------------------------------------------------------------------


def utilhash(a):
    """32-bit integer hash (per-pixel Sobol scrambling).  ``a``: integer
    tensor; returns int64 values in [0, 2^32), bit-equal to the reference's
    uint32 chain (negative inputs wrap like a uint32 cast)."""
    a = a.to(torch.int64) & U32
    a = ((a + 0x7ED55D16) + (a << 12)) & U32
    a = (a ^ 0xC761C23C) ^ (a >> 19)
    a = ((a + 0x165667B1) + (a << 5)) & U32
    a = ((a + 0xD3A2646C) ^ (a << 9)) & U32
    a = ((a + 0xFD7046C5) + (a << 3)) & U32
    a = (a ^ 0xB55A4F09) ^ (a >> 16)
    return a


def u32_to_unit(bits):
    """u32 bits (int64) -> f32 in [0, 1]: f32(bits) * 2^-32, rounding like
    the reference's u32 -> f32 convert."""
    return bits.to(prec.FT) * INV_2_32


# ---------------------------------------------------------------------------
# normal hemi-octahedral encoding (mathUtil.h:38-47)
# ---------------------------------------------------------------------------


def encode_normal_hemioct(n):
    """Unit normal [..., 3] (z >= 0 hemisphere) -> 2 components."""
    denom = (torch.abs(n[..., 0]) + torch.abs(n[..., 1])
             + torch.clamp(n[..., 2], min=1e-12))
    p = n[..., :2] / denom[..., None]
    return torch.stack([p[..., 0] + p[..., 1], p[..., 0] - p[..., 1]], dim=-1)


def decode_normal_hemioct(e):
    tx = (e[..., 0] + e[..., 1]) * 0.5
    ty = (e[..., 0] - e[..., 1]) * 0.5
    tz = 1.0 - torch.abs(tx) - torch.abs(ty)
    return normalize(torch.stack([tx, ty, tz], dim=-1))


# ---------------------------------------------------------------------------
# host-side transform matrices (mathUtil.cpp:12-25)
# ---------------------------------------------------------------------------


def build_transformation_matrix(
    translation, rotation_deg, scale
) -> np.ndarray:
    """4x4 TRS matrix: T * Rx * Ry * Rz * S, rotations in degrees (matches
    glm::rotate order in reference mathUtil.cpp:12-25)."""
    t = np.asarray(translation, dtype=np.float64)
    r = np.radians(np.asarray(rotation_deg, dtype=np.float64))
    s = np.asarray(scale, dtype=np.float64)

    def rot(axis, ang):
        c, si = np.cos(ang), np.sin(ang)
        m = np.eye(4)
        if axis == 0:
            m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -si, si, c
        elif axis == 1:
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, si, -si, c
        else:
            m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -si, si, c
        return m

    T = np.eye(4)
    T[:3, 3] = t
    S = np.diag([s[0], s[1], s[2], 1.0])
    M = T @ rot(0, r[0]) @ rot(1, r[1]) @ rot(2, r[2]) @ S
    return M.astype(np.float32)
