"""Differentiable rendering entry points.

The reference engine has no gradients at all; differentiability is a
first-class goal of this renderer (BASELINE.json): pixel values are
differentiable w.r.t. material albedo/roughness, light parameters, and
camera/object transforms. Strategy (SURVEY.md §7): detached sampling — hit
*topology* (which prim, which lobe, which light) carries no gradient, while
(t, u, v), shading, NEE and accumulation are analytic jnp math.

Supported parameter groups (``apply_params``):
    base_color  (M, 3)  per-model albedo        -> scene.mat_base
    roughness   (M,)    per-model roughness     -> scene.mat_rough
    metalness   (M,)    per-model metalness     -> scene.mat_metal
    emissive    (M, 3)  per-model emission      -> scene.mat_emissive
    point_color (NP, 3) point-light intensity   -> lights.point_color
    dir_color   (ND, 3)                          -> lights.dir_color
    area_color  (NA, 3)                          -> lights.area_color
    translation (Ninst, 3) per-instance offset  -> world geometry (tri_v0,
        corner data); BVH topology is frozen (valid for small perturbations —
        the differentiable-rendering convention for silhouette-free grads)
    instance_trs {position (I,3), rotation (I,3) Euler radians,
        scale (I,3), base_inv (I,4,4) constant}  -> FULL differentiable TRS
        re-bake (rotation/scale/translation gradients matching the
        reference's T*R(quat-from-euler)*S chain, Core/GameObject.cpp:55-69;
        build the group with ``trs_params_from_instances``)
    camera_pos  (3,)                             -> camera position
    camera_target (3,)                           -> camera target (the full
        look-at chain — basis vectors, screen corners — is differentiable
        in scene/camera.py's pure functions)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from physically_based_ray_tracer_tpu.config import RenderConfig
from physically_based_ray_tracer_tpu.render.integrator import render_sample
from physically_based_ray_tracer_tpu.scene.camera import Camera
from physically_based_ray_tracer_tpu.scene.scene import SceneData


# ---------------------------------------------------------------------------
# Differentiable TRS (jnp port of utils/math.compose_trs — the exact
# GameObject::Synchronise composition, Core/GameObject.cpp:55-69: GLM
# Euler->quat, T * R * S)
# ---------------------------------------------------------------------------

def quat_from_euler_jnp(euler):
    """(..., 3) Euler radians -> (..., 4) quaternion (x, y, z, w), GLM
    pitch/yaw/roll convention (matches utils/math.quat_from_euler)."""
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = jnp.cos(rx * 0.5), jnp.sin(rx * 0.5)
    cy, sy = jnp.cos(ry * 0.5), jnp.sin(ry * 0.5)
    cz, sz = jnp.cos(rz * 0.5), jnp.sin(rz * 0.5)
    w = cx * cy * cz + sx * sy * sz
    x = sx * cy * cz - cx * sy * sz
    y = cx * sy * cz + sx * cy * sz
    z = cx * cy * sz - sx * sy * cz
    return jnp.stack([x, y, z, w], axis=-1)


def quat_to_matrix_jnp(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                    2 * (x * z + w * y)], axis=-1)
    r1 = jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                    2 * (y * z - w * x)], axis=-1)
    r2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                    1 - 2 * (x * x + y * y)], axis=-1)
    return jnp.stack([r0, r1, r2], axis=-2)


def trs_matrix_jnp(position, rotation_euler, scale):
    """(..., 3)x3 -> (..., 3, 4) affine T*R(quat-from-euler)*S, matching
    ``compose_trs`` / Core/GameObject.cpp:55-69 exactly but differentiable."""
    R = quat_to_matrix_jnp(quat_from_euler_jnp(rotation_euler))
    L = R * scale[..., None, :]                      # R @ diag(s)
    return jnp.concatenate([L, position[..., :, None]], axis=-1)


def trs_params_from_instances(instances):
    """Initial ``instance_trs`` parameter group for a list of scene
    Instances: the live TRS plus the (constant) baked base matrices that
    ``apply_params`` composes against. Gradients at this initial point are
    exactly d(pixel)/d(position|rotation|scale) of the reference's own
    transform chain."""
    pos = jnp.asarray([i.position for i in instances], jnp.float32)
    rot = jnp.asarray([i.rotation for i in instances], jnp.float32)
    scl = jnp.asarray([i.scale for i in instances], jnp.float32)
    base = np.stack([np.asarray(i.transform, np.float64) for i in instances])
    base_inv = jnp.asarray(np.linalg.inv(base), jnp.float32)   # (I, 4, 4)
    return {"position": pos, "rotation": rot, "scale": scl,
            "base_inv": base_inv}


def apply_params(scene: SceneData, cam: Camera, params: dict):
    """Return (scene', cam') with parameter group overrides applied."""
    s = scene
    if "base_color" in params:
        s = s._replace(mat_base=params["base_color"])
    if "roughness" in params:
        s = s._replace(mat_rough=params["roughness"])
    if "metalness" in params:
        s = s._replace(mat_metal=params["metalness"])
    if "emissive" in params:
        s = s._replace(mat_emissive=params["emissive"])
    lights = s.lights
    if "point_color" in params:
        lights = lights._replace(point_color=params["point_color"])
    if "dir_color" in params:
        lights = lights._replace(dir_color=params["dir_color"])
    if "area_color" in params:
        lights = lights._replace(area_color=params["area_color"])
    if lights is not s.lights:
        s = s._replace(lights=lights)
    if "translation" in params:
        # per-instance world offset; gathers the per-prim instance id.
        off = params["translation"]                       # (Ninst, 3)
        per_prim = jnp.take(off, s.prim_inst, axis=0)     # (P, 3)
        s = s._replace(
            tri_v0=s.tri_v0 + per_prim,
            # e1/e2 are translation-invariant; corner normals too.
        )
        # NOTE: bvh geometry is intentionally left untouched (stop_gradient
        # + frozen topology); hits come from the baked BVH, shading from the
        # translated tri_v0 via refine_hit.
    if "instance_trs" in params:
        # FULL differentiable TRS per instance (BASELINE "object transforms"): the world bake (_bake_world) is
        # pure math, so re-derive the baked arrays under the delta
        # transform A_i = M(pos, rot, scale)_i @ inv(M_base_i). At the
        # initial parameters A = identity and gradients equal the
        # reference composition's own Jacobian (Core/GameObject.cpp:55-69).
        # BVH topology stays frozen exactly like the translation group.
        g = params["instance_trs"]
        M = trs_matrix_jnp(g["position"], g["rotation"], g["scale"])  # (I,3,4)
        base_inv = jax.lax.stop_gradient(
            jnp.asarray(g["base_inv"], jnp.float32))      # (I, 4, 4)
        # f32 contractions at HIGHEST precision: on the GPU a default
        # einsum may run in TF32 (about three decimal digits)
        hi = jax.lax.Precision.HIGHEST
        L = jnp.einsum("iab,ibc->iac", M[:, :, 0:3], base_inv[:, 0:3, 0:3],
                       precision=hi)
        tcol = (jnp.einsum("iab,ib->ia", M[:, :, 0:3], base_inv[:, 0:3, 3],
                           precision=hi)
                + M[:, :, 3])                             # (I, 3)
        invT = jnp.linalg.inv(L).transpose(0, 2, 1)       # normal matrix
        Lp = jnp.take(L, s.prim_inst, axis=0)             # (P, 3, 3)
        tp = jnp.take(tcol, s.prim_inst, axis=0)          # (P, 3)
        nTp = jnp.take(invT, s.prim_inst, axis=0)
        mm = lambda A, x: jnp.einsum("pab,pb->pa", A, x, precision=hi)
        # rsqrt-of-clamped-square normalize: |x|=0 rows (degenerate pole
        # triangles) keep a FINITE zero gradient; linalg.norm's vjp at 0
        # is NaN and would poison the whole transform gradient
        nrm = lambda x: x * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(x * x, axis=-1, keepdims=True), 1e-20))
        corner_inst = jnp.repeat(s.prim_inst, 3, axis=0)
        Lc = jnp.take(invT, corner_inst, axis=0)
        s = s._replace(
            tri_v0=mm(Lp, s.tri_v0) + tp,
            tri_e1=mm(Lp, s.tri_e1),
            tri_e2=mm(Lp, s.tri_e2),
            face_normal=nrm(mm(nTp, s.face_normal)),
            corner_normal=nrm(mm(Lc, s.corner_normal)),
        )
    if "camera_pos" in params:
        cam = cam._replace(pos=params["camera_pos"])
    if "camera_target" in params:
        cam = cam._replace(target=params["camera_target"])
    return s, cam


def render_color(scene: SceneData, cam: Camera, cfg: RenderConfig, key,
                 sample, pixel_ids):
    """Raw linear radiance for a pixel batch (no film) — the differentiable
    quantity; gamma/accumulation are monotone postprocessing."""
    color, _ = render_sample(scene, cam, cfg, key, sample, pixel_ids)
    return color


def make_loss_fn(scene: SceneData, cam: Camera, cfg: RenderConfig, target,
                 pixel_ids, axis_name: str | None = None):
    """L2 image loss over a pixel batch as a function of a params dict.

    With ``axis_name`` set (inside shard_map), loss and grads are averaged
    over the mesh axis — the gradient all-reduce of SURVEY.md §5.
    """

    def loss_fn(params, key, sample):
        s, c = apply_params(scene, cam, params)
        color = render_color(s, c, cfg, key, sample, pixel_ids)
        loss = jnp.mean((color - target) ** 2)
        if axis_name is not None:
            loss = jax.lax.pmean(loss, axis_name)
        return loss

    return loss_fn


def grad_check_fd(f, x, eps: float = 1e-3, atol: float = 1e-3, rtol: float = 0.15):
    """Compare analytic grad of scalar f at x (flat array) vs central FD.

    Returns (analytic, fd, ok_mask) — used by tests/test_grad.py for the
    BASELINE gradient-correctness criterion.
    """
    g = jax.grad(f)(x)
    g = jnp.asarray(g)
    fd = []
    import numpy as np
    xf = np.asarray(x, np.float64)
    for i in range(xf.size):
        d = np.zeros_like(xf)
        d.flat[i] = eps
        fp = float(f(jnp.asarray(xf + d, jnp.float32)))
        fm = float(f(jnp.asarray(xf - d, jnp.float32)))
        fd.append((fp - fm) / (2 * eps))
    fd = np.asarray(fd).reshape(xf.shape)
    ga = np.asarray(g, np.float64)
    ok = np.isclose(ga, fd, atol=atol, rtol=rtol)
    return ga, fd, ok
