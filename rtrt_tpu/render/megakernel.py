"""Component-form twin of the path-trace bounce program.

`shade_segment` re-expresses the integrator's shading
(render/integrator.py::_segment) over per-component arrays (render/kshade),
the form a fused one-kernel-per-frame path tracer would use (reference:
src/pathtrace.cuh:11-128 runs primary + glossy + diffuse interactions in a
single megakernel).  `simulate_megakernel` runs that program under plain
XLA with the wavefront traverser; tests hold it equal to the integrator
(tests/test_megakernel.py), which keeps the component shading library
correct for a later fused GPU kernel.  The deferred-environment resolve +
demodulation tail lives in `finish_gbuffer`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from .bsdf import MAT_EMISSIVE
from .kshade import (MAT_ROW, BsdfSampleC, SunParamsC, V3, bwhere, eval_bsdf_c,
                     material_select_c, orient_normals_c, power_heuristic_c,
                     rand2_bn_c, rand2_c, ray_sphere_c, sample_bsdf_c,
                     sample_sphere_light_c,
                     sample_sun_c, soil_shading_c, sphere_lights_pdf_c, v3_const,
                     vdot, vlum, vwhere)

import os as _os

# scene intersects per pixel (matches integrator.SEGMENTS)
SEGMENTS = int(_os.environ.get("RTRT_SEGMENTS", "5"))
LIGHT_ROW = 8  # packed sphere-light row: [cx cy cz radius ex ey ez pad]


class PathState(NamedTuple):
    """Full per-lane path state (component arrays of one common shape)."""

    org: V3
    dir: V3
    beta: V3
    radiance: V3
    done: Any
    is_shadow: Any
    pending: V3
    shadow_tmax: Any
    prev_pdf: Any
    prev_delta: Any
    inside: Any
    cone: Any
    esc_dir: V3
    esc_beta: V3
    esc_pdf: Any
    esc_delta: Any
    albedo: V3
    normal: V3
    depth: Any
    mat_id: Any
    got_primary: Any


class ShadeCtx(NamedTuple):
    """Static shading context threaded through the segments."""

    sun: SunParamsC
    read_mat: Callable        # i -> (MAT_ROW,) material row
    read_light: Callable      # i -> (LIGHT_ROW,) light row (unused if 0)
    n_materials: int
    n_lights: int
    use_proctex: bool
    rand2: Callable = None    # dim -> (u1, u2): per-pixel LD sampler
    ftex: Any = None          # FourierTextures: image-derived materials
    #   (render/ftex.py) — overrides procedural soil when set


class MegaOut(NamedTuple):
    """Kernel outputs, flat (N,) / (N,3) arrays (wrapper re-stacks)."""

    radiance: jnp.ndarray  # (N,3) pre-environment path radiance
    albedo: jnp.ndarray    # (N,3)
    normal: jnp.ndarray    # (N,3)
    depth: jnp.ndarray     # (N,)  inf = sky
    mat_id: jnp.ndarray    # (N,)  i32 (-1 = sky)
    esc_dir: jnp.ndarray   # (N,3) escape direction (deferred env eval)
    esc_beta: jnp.ndarray  # (N,3) throughput at escape (0 if none)
    esc_pdf: jnp.ndarray   # (N,)  BSDF pdf at escape; -1 marks delta


def init_state(org: V3, dir: V3, cone) -> PathState:
    shape = org.x.shape
    zf = lambda: jnp.zeros(shape, jnp.float32)
    z3 = lambda: V3(zf(), zf(), zf())
    one3 = V3(jnp.ones(shape, jnp.float32), jnp.ones(shape, jnp.float32),
              jnp.ones(shape, jnp.float32))
    f = lambda: jnp.zeros(shape, bool)
    t = lambda: jnp.ones(shape, bool)
    return PathState(
        org=org, dir=dir, beta=one3, radiance=z3(),
        done=f(), is_shadow=f(), pending=z3(),
        shadow_tmax=jnp.full(shape, jnp.inf, jnp.float32),
        prev_pdf=zf(), prev_delta=t(), inside=f(), cone=cone,
        esc_dir=dir, esc_beta=z3(), esc_pdf=zf(), esc_delta=t(),
        albedo=one3, normal=z3(),
        depth=jnp.full(shape, jnp.inf, jnp.float32),
        mat_id=jnp.full(shape, -1, jnp.int32), got_primary=f())


def shade_segment(st: PathState, hit, ctx: ShadeCtx, pix, frame, seg: int,
                  is_last: bool) -> PathState:
    """One bounce of shading over component arrays — the exact mirror of
    integrator._segment (reference: src/surfaceInteraction.cuh:36-310).

    hit: the 11-tuple from bvh.packet.traverse_tile (t=inf on miss).
    Pure jnp math — runs identically inside Pallas and under plain XLA.
    """
    (ht, tri, hu, hv, hmat, nsx, nsy, nsz, ngx, ngy, ngz) = hit
    zero3 = v3_const(0.0, 0.0, 0.0)

    active = ~st.done
    found = (tri >= 0) & active

    # ---------------- shadow-ray resolution ----------------
    sh = st.is_shadow & active
    unocc = sh & ~(tri >= 0)
    radiance = vwhere(unocc, st.radiance + st.pending, st.radiance)
    done = st.done | sh

    # ---------------- analytic sphere-light hits (scatter rays) -----------
    if ctx.n_lights > 0:
        lt = jnp.full(ht.shape, jnp.inf, jnp.float32)
        lem = zero3
        for li in range(ctx.n_lights):
            row = ctx.read_light(li)
            hl, tl = ray_sphere_c(st.org, st.dir, V3(row[0], row[1], row[2]),
                                  row[3])
            closer = hl & (tl < lt)
            lt = jnp.where(closer, tl, lt)
            lem = vwhere(closer, V3(row[4], row[5], row[6]), lem)
        lhit = active & ~sh & (lt < ht)
        lpdf_sphere = sphere_lights_pdf_c(ctx.read_light, ctx.n_lights,
                                          st.org, st.dir)
        w_l = jnp.where(st.prev_delta, 1.0,
                        power_heuristic_c(st.prev_pdf, 0.5 * lpdf_sphere))
        radiance = vwhere(lhit, radiance + st.beta * lem * w_l, radiance)
        done = done | lhit

    # ---------------- escaped scatter rays: defer env to the end ----------
    esc = active & ~sh & ~(tri >= 0)
    esc_dir = vwhere(esc, st.dir, st.esc_dir)
    esc_beta = vwhere(esc, st.beta, st.esc_beta)
    esc_pdf = jnp.where(esc, st.prev_pdf, st.esc_pdf)
    esc_delta = bwhere(esc, st.prev_delta, st.esc_delta)
    done = done | esc

    live = found & ~sh & ~done
    st = st._replace(radiance=radiance, done=done, esc_dir=esc_dir,
                     esc_beta=esc_beta, esc_pdf=esc_pdf, esc_delta=esc_delta)
    if is_last:
        return st._replace(done=done | live)

    # ---------------- surface interaction ----------------
    wo = -st.dir
    # finite everywhere; == ht on live lanes (misses carry +inf; resolved
    # shadow lanes carry -inf after the first-hit collapse — clip both so
    # pos/cone stay NaN-free on the masked-out lanes)
    ts = jnp.clip(ht, 0.0, 1e8)
    pos = st.org + st.dir * ts
    cone_w = st.cone * ts
    ns, ng = orient_normals_c(V3(nsx, nsy, nsz), V3(ngx, ngy, ngz), wo)
    mtype, albedo, rough, ior, f0, emission, textured = material_select_c(
        ctx.read_mat, ctx.n_materials, hmat)
    if ctx.use_proctex or ctx.ftex is not None:
        # most tiles have NO textured lanes in late segments (done/sky
        # lanes carry mat_id -1 or delta materials), so the whole
        # evaluation is gated on a tile-level any().  Semantics identical:
        # masked-out lanes never read tex_*.
        # ctx.ftex switches textured materials to the FITTED image
        # textures (render/ftex.py — analytic Fourier eval, zero gathers).
        def _do_tex(a):
            alb, rgh, n = a
            if ctx.ftex is not None:
                from .ftex import ftex_shading_c
                tex_alb, tex_rough, ns_tex = ftex_shading_c(
                    ctx.ftex, pos, ns, cone_w)
            else:
                tex_alb, tex_rough, ns_tex = soil_shading_c(pos, ns, cone_w)
            return (vwhere(textured, alb * tex_alb, alb),
                    jnp.where(textured, tex_rough, rgh),
                    vwhere(textured, ns_tex, n))

        albedo, rough, ns = jax.lax.cond(
            jnp.any(textured & live), _do_tex, lambda a: a,
            (albedo, rough, ns))

    # emissive surfaces add radiance and terminate
    emissive = live & (mtype == MAT_EMISSIVE)
    radiance = vwhere(emissive, st.radiance + st.beta * emission, st.radiance)
    done = done | emissive
    live = live & ~emissive

    # primary-hit G-buffer capture (reference: pathtrace.cuh:123-127)
    first = live & ~st.got_primary
    alb_c = V3(jnp.maximum(albedo.x, 1e-3), jnp.maximum(albedo.y, 1e-3),
               jnp.maximum(albedo.z, 1e-3))
    normal = vwhere(first, ns, st.normal)
    depth = jnp.where(first, ht, st.depth)
    mat_id = jnp.where(first, hmat, st.mat_id)
    alb_g = vwhere(first, alb_c, st.albedo)
    got_primary = st.got_primary | live

    # low-discrepancy dims for this bounce (same dims as the integrator)
    u1b, u2b = ctx.rand2(jnp.uint32(2 + 2 * seg))
    ul1, ul2 = ctx.rand2(jnp.uint32(64 + 2 * seg))
    u_sel, _ = ctx.rand2(jnp.uint32(128 + 2 * seg))

    bs: BsdfSampleC = sample_bsdf_c(mtype, albedo, rough, ior, f0, ns, wo,
                                    st.inside, u1b, u2b)
    rough_lane = live & ~bs.is_delta

    # --- light sample + MIS (rough surfaces only): analytic sun NEE,
    # 50/50 mixed with sphere-light NEE when local lights exist ---
    ls_wi, ls_rad, ls_pdf = sample_sun_c(ctx.sun, ul1, ul2)
    ls_dist = jnp.full(ht.shape, jnp.inf, jnp.float32)
    if ctx.n_lights > 0:
        nl = ctx.n_lights
        p1, p2 = ctx.rand2(jnp.uint32(192 + 2 * seg))
        li = jnp.clip((p1 * nl).astype(jnp.int32), 0, nl - 1)
        sp_wi, sp_rad, sp_pdf, sp_dist = sample_sphere_light_c(
            ctx.read_light, nl, li, pos, ul1, ul2)
        use_sphere = p2 < 0.5
        ls_wi = vwhere(use_sphere, sp_wi, ls_wi)
        ls_rad = vwhere(use_sphere, sp_rad, ls_rad)
        ls_pdf = jnp.where(use_sphere, 0.5 * sp_pdf / nl, 0.5 * ls_pdf)
        ls_dist = jnp.where(use_sphere, sp_dist, ls_dist)

    f_l, pdf_b_at_l = eval_bsdf_c(mtype, albedo, rough, f0, ns, wo, ls_wi)
    cos_l = jnp.maximum(vdot(ns, ls_wi), 0.0)
    w_l2 = power_heuristic_c(ls_pdf, pdf_b_at_l)
    scale_l = (cos_l / jnp.maximum(ls_pdf, 1e-8)) * w_l2
    c_light = st.beta * f_l * ls_rad * scale_l
    c_light = vwhere(ls_pdf > 1e-8, c_light, zero3)

    # --- stochastic single-ray selection (the reference's MIS trick,
    # src/surfaceInteraction.cuh:233-304) ---
    est_l = vlum(c_light)
    est_s = vlum(st.beta * bs.weight)
    q = jnp.where(est_l + est_s > 0.0,
                  est_l / jnp.maximum(est_l + est_s, 1e-12), 0.0)
    q = jnp.clip(q, 0.0, 0.9)
    take_shadow = rough_lane & (u_sel < q) & (est_l > 0.0)

    is_shadow = take_shadow
    pending = vwhere(take_shadow, c_light * (1.0 / jnp.maximum(q, 1e-3)),
                     zero3)
    shadow_tmax = jnp.where(take_shadow, ls_dist, jnp.inf)

    scatter = live & ~take_shadow
    inv_p = jnp.where(rough_lane, 1.0 / jnp.maximum(1.0 - q, 1e-3), 1.0)
    beta = vwhere(scatter, st.beta * bs.weight * inv_p, st.beta)
    prev_pdf = jnp.where(scatter, bs.pdf, st.prev_pdf)
    prev_delta = bwhere(scatter, bs.is_delta, st.prev_delta)

    # glass transmission flips inside-ness when crossing the surface
    crossed = scatter & (vdot(bs.wi, ng) < 0.0)
    inside = bwhere(crossed, ~st.inside, st.inside)

    new_dir = vwhere(take_shadow, ls_wi, bs.wi)
    off = vwhere(vdot(new_dir, ng) >= 0.0, ng * 1e-3, ng * (-1e-3))
    org = vwhere(live, pos + off, st.org)
    dir = vwhere(live, new_dir, st.dir)
    cone = jnp.where(live, cone_w, st.cone)

    done = done | (live & ~take_shadow & (vlum(beta) < 1e-5))
    return PathState(org=org, dir=dir, beta=beta, radiance=radiance,
                     done=done, is_shadow=is_shadow, pending=pending,
                     shadow_tmax=shadow_tmax, prev_pdf=prev_pdf,
                     prev_delta=prev_delta, inside=inside, cone=cone,
                     esc_dir=st.esc_dir, esc_beta=st.esc_beta,
                     esc_pdf=st.esc_pdf, esc_delta=st.esc_delta,
                     albedo=alb_g, normal=normal, depth=depth, mat_id=mat_id,
                     got_primary=got_primary)


def pack_light_rows(lights):
    """SphereLights -> (L, LIGHT_ROW) f32 row table (None -> (1,8) zeros)."""
    if lights is None:
        return jnp.zeros((1, LIGHT_ROW), jnp.float32)
    nl = lights.center.shape[0]
    return jnp.concatenate(
        [lights.center.astype(jnp.float32),
         lights.radius.astype(jnp.float32)[:, None],
         lights.emission.astype(jnp.float32),
         jnp.zeros((nl, 1), jnp.float32)], axis=1)


def pack_sun_params(sky) -> jnp.ndarray:
    """SkyMaps -> (16,) f32 dynamic sun-state vector for SMEM."""
    from .sky import SUN_COS_THETA_MAX
    return jnp.concatenate([
        sky.sun_dir.astype(jnp.float32),
        sky.sun_basis_t.astype(jnp.float32),
        sky.sun_basis_b.astype(jnp.float32),
        sky.sun_trans.astype(jnp.float32),
        jnp.reshape(sky.params.sun_intensity.astype(jnp.float32), (1,)),
        jnp.full((1,), SUN_COS_THETA_MAX, jnp.float32),
        jnp.zeros((2,), jnp.float32)])


def _unpack_sun(read) -> SunParamsC:
    """read: i -> scalar f32 (SMEM element or array element).

    cos_theta_max stays the STATIC module constant (not the f32 vector
    slot): 1-cos²θ suffers catastrophic cancellation, so it must be folded
    at trace time in float64 exactly as render/sky.py folds it."""
    from .sky import SUN_COS_THETA_MAX
    return SunParamsC(
        dir=V3(read(0), read(1), read(2)),
        t=V3(read(3), read(4), read(5)),
        b=V3(read(6), read(7), read(8)),
        trans=V3(read(9), read(10), read(11)),
        intensity=read(12), cos_theta_max=SUN_COS_THETA_MAX)


# ---------------------------------------------------------------------------
# pure-XLA twin (CPU oracle) + shared G-buffer tail
# ---------------------------------------------------------------------------


def simulate_megakernel(scene, rays, pixel_ids, frame_idx, *,
                        max_steps=1024, use_proctex=True, bn=None,
                        ftex=None) -> MegaOut:
    """Run the megakernel's exact shading program under plain XLA, with the
    wavefront traverser standing in for the packet kernel — the CPU oracle
    for tests (same component math, same RNG dims, same masks)."""
    from ..bvh.traverse import intersect_scene
    from .kshade import pack_materials_rows

    mat_rows = pack_materials_rows(scene.materials)
    light_rows = pack_light_rows(scene.lights)
    sun_vec = pack_sun_params(scene.sky)
    n_lights = 0 if scene.lights is None else scene.lights.center.shape[0]
    sun = _unpack_sun(lambda i: sun_vec[i])
    frame = jnp.asarray(frame_idx).astype(jnp.uint32)
    pix = pixel_ids.astype(jnp.int32)
    if bn is not None:
        sampler = lambda d: rand2_bn_c(bn[:, 0], bn[:, 1], frame, d)
    else:
        sampler = lambda d: rand2_c(pix, frame, d)
    ctx = ShadeCtx(sun=sun,
                   read_mat=lambda i: mat_rows[i],
                   read_light=lambda i: light_rows[i],
                   n_materials=mat_rows.shape[0], n_lights=n_lights,
                   use_proctex=use_proctex, rand2=sampler, ftex=ftex)

    st = init_state(V3(rays.org[:, 0], rays.org[:, 1], rays.org[:, 2]),
                    V3(rays.dir[:, 0], rays.dir[:, 1], rays.dir[:, 2]),
                    rays.cone_width)

    for seg in range(SEGMENTS):
        t_cap = jnp.where(st.done, 0.0,
                          jnp.where(st.is_shadow, st.shadow_tmax, jnp.inf))
        o = jnp.stack([st.org.x, st.org.y, st.org.z], axis=-1)
        d = jnp.stack([st.dir.x, st.dir.y, st.dir.z], axis=-1)
        h = intersect_scene(scene.bvh, o, d, t_cap, max_steps=max_steps)
        # surface attributes via the gather fallback (equals the packet
        # kernel's in-kernel attribute math on hit lanes)
        t = jnp.maximum(h.tri, 0)
        w = 1.0 - h.u - h.v
        nc = [scene.tri_nrm_t[k][t] for k in range(9)]
        nsx = w * nc[0] + h.u * nc[3] + h.v * nc[6]
        nsy = w * nc[1] + h.u * nc[4] + h.v * nc[7]
        nsz = w * nc[2] + h.u * nc[5] + h.v * nc[8]
        vc = [scene.bvh.tris_t[k][t] for k in range(9)]
        e1 = (vc[3] - vc[0], vc[4] - vc[1], vc[5] - vc[2])
        e2 = (vc[6] - vc[0], vc[7] - vc[1], vc[8] - vc[2])
        ngx = e1[1] * e2[2] - e1[2] * e2[1]
        ngy = e1[2] * e2[0] - e1[0] * e2[2]
        ngz = e1[0] * e2[1] - e1[1] * e2[0]
        gl = jax.lax.rsqrt(jnp.maximum(ngx * ngx + ngy * ngy + ngz * ngz,
                                       1e-20))
        hit = (h.t, h.tri, h.u, h.v, scene.tri_mat[t],
               nsx, nsy, nsz, ngx * gl, ngy * gl, ngz * gl)
        st = shade_segment(st, hit, ctx, pix, frame, seg,
                           is_last=(seg == SEGMENTS - 1))

    return MegaOut(
        radiance=jnp.stack([st.radiance.x, st.radiance.y, st.radiance.z], -1),
        albedo=jnp.stack([st.albedo.x, st.albedo.y, st.albedo.z], -1),
        normal=jnp.stack([st.normal.x, st.normal.y, st.normal.z], -1),
        depth=st.depth, mat_id=st.mat_id,
        esc_dir=jnp.stack([st.esc_dir.x, st.esc_dir.y, st.esc_dir.z], -1),
        esc_beta=jnp.stack([st.esc_beta.x, st.esc_beta.y, st.esc_beta.z], -1),
        esc_pdf=jnp.where(st.esc_delta, -1.0, st.esc_pdf))


def finish_gbuffer(scene, rays, out: MegaOut, prev_basis, aspect,
                   env_fn=None):
    """Deferred environment resolve + demodulation + motion vector — the
    integrator's post-loop tail (shared by kernel and simulator paths).

    env_fn: optional (org, dir) -> (...,3) escape-environment override
    (render/environment.py: sky + ocean + stars)."""
    from ..core.camera import motion_vector
    from .integrator import GBuffer, RADIANCE_CLAMP
    from .light import sun_pdf_dir
    from .sampling import power_heuristic
    from .sky import env_radiance_fit

    # Chebyshev-fit environment eval: dense arithmetic instead of the
    # analytic raymarch, <0.5% rel error (render/sky.py::env_radiance_fit,
    # tested vs the analytic oracle)
    env = (env_fn(rays.org, out.esc_dir) if env_fn is not None
           else env_radiance_fit(scene.sky, out.esc_dir))
    lpdf = sun_pdf_dir(scene.sky, out.esc_dir)
    w_env = jnp.where(out.esc_pdf < 0.0, 1.0,
                      power_heuristic(1.0, out.esc_pdf, 1.0, lpdf))
    radiance = out.radiance + out.esc_beta * env * w_env[..., None]

    safe_albedo = jnp.maximum(out.albedo, 1e-3)
    color = jnp.clip(radiance, 0.0, RADIANCE_CLAMP) / safe_albedo

    mv = motion_vector(prev_basis, rays.uv,
                       rays.org + rays.dir
                       * jnp.minimum(out.depth, 1e8)[..., None], aspect)
    return GBuffer(color=color, albedo=out.albedo, normal=out.normal,
                   depth=out.depth, motion=mv, mat_id=out.mat_id)
