"""Wavefront path-tracing integrator (1 spp, fixed bounce program, MIS).

Counterpart of the reference's PathTrace megakernel
(reference: src/pathtrace.cuh:11-128) and its bounce logic
(reference: src/surfaceInteraction.cuh:11-310, src/traverse.cuh:9-56):

  * fixed unrolled bounce program of `SEGMENTS` scene intersections — the
    analog of the reference's primary + 3 glossy + 2 diffuse chain
    (pathtrace.cuh:66-105); every lane walks the same program with masks;
  * NEE with *single-ray MIS selection*: at a rough hit the lane samples BOTH
    the light and the BSDF, then stochastically continues along ONE of them
    (the reference's power-heuristic ray-selection trick,
    surfaceInteraction.cuh:233-304) — one traversal per bounce, total
    traversal count matches the reference's ~5 intersects/pixel budget;
  * shadow rays resolve against the environment in the NEXT segment's
    intersect (miss == unoccluded), exactly like the reference's
    shadow-ray / GetLightSource flow;
  * primary hit writes the G-buffer the denoiser needs: demodulated
    radiance, albedo, shading normal, depth, material id, motion vector
    (pathtrace.cuh:121-127);
  * radiance clamped to [0, CLAMP] against fireflies (pathtrace.cuh:108-119).

Each segment is one scene intersect (the GPU traversal kernel or the XLA
wavefront reference, chosen by `trace`) followed by shading as XLA fusions:
  * surface attributes (normals, material id) are gathered per hit lane;
  * material parameters resolve through a static where-chain
    (bsdf.material_lookup), textures are analytic procedural noise
    (render/proctex.py), env sampling uses O(1) alias tables (render/light),
    and escaped-ray radiance is DEFERRED: each lane records its escape
    direction and throughput, and ONE analytic atmosphere evaluation runs
    after the bounce loop instead of per segment.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..bvh.lane_traverse import intersect
from ..bvh.traverse import SceneBvh
from ..core.camera import CameraBasis, motion_vector
from ..core.vecmath import dot, normalize
from .bsdf import (MAT_EMISSIVE, Materials, eval_bsdf, material_lookup,
                   sample_bsdf)
from .light import (SphereLights, env_light_pdf, env_radiance,
                    sample_env_light, sample_sphere_light, sample_sun,
                    sun_pdf_dir)
from ..core.geometry import ray_sphere
from .raygen import Rays
from .sampling import power_heuristic, rand2, white2
from .sky import SkyMaps, env_radiance_fit
from .texture import SoilTextures, apply_normal_map, triplanar_sample
from .proctex import soil_shading

import os as _os

# scene intersects per pixel (reference: ~5).  RTRT_SEGMENTS overrides for
# trace-attribution A/Bs and for compile-budget-bound validation runs (the
# multichip dryrun shrinks the wavefront bounce program this way).
SEGMENTS = int(_os.environ.get("RTRT_SEGMENTS", "5"))
RADIANCE_CLAMP = 10.0  # reference: pathtrace.cuh:108-119


class SceneData(NamedTuple):
    """Everything the integrator needs, in sorted-leaf triangle order."""

    bvh: SceneBvh
    tri_nrm_t: jnp.ndarray  # (9, T) [n0x..n2z] vertex normals, sorted order
    tri_mat: jnp.ndarray    # (T,) i32 material ids (sorted order)
    materials: Materials
    sky: SkyMaps
    textures: SoilTextures
    lights: SphereLights | None = None  # analytic local lights (or None)


class GBuffer(NamedTuple):
    """Per-pixel wavefront outputs consumed by the denoiser
    (the analog of the reference's 20-buffer set written at
    pathtrace.cuh:123-127)."""

    color: jnp.ndarray    # (N,3) albedo-demodulated radiance
    albedo: jnp.ndarray   # (N,3)
    normal: jnp.ndarray   # (N,3)
    depth: jnp.ndarray    # (N,) view depth (inf = sky)
    motion: jnp.ndarray   # (N,2) uv motion vector
    mat_id: jnp.ndarray   # (N,) i32 (-1 = sky) — the material mask


def _sphere_lights_pdf(lights: SphereLights, org, d, t_hit):
    """Solid-angle pdf that sphere-light NEE generates direction d from org
    (uniform pick among lights x cone pdf)."""
    from .sampling import uniform_cone_pdf
    nl = lights.center.shape[0]
    pdf = jnp.zeros(d.shape[:-1], jnp.float32)
    for li in range(nl):
        to_c = lights.center[li] - org
        d2 = jnp.maximum(jnp.sum(to_c * to_c, axis=-1), 1e-8)
        sin2 = jnp.clip(lights.radius[li] ** 2 / d2, 0.0, 0.9999)
        cos_max = jnp.sqrt(1.0 - sin2)
        # does d point into this light's cone?
        cosg = jnp.sum(d * to_c / jnp.sqrt(d2)[..., None], axis=-1)
        pdf = pdf + jnp.where(cosg > cos_max,
                              uniform_cone_pdf(cos_max) / nl, 0.0)
    return pdf


def _orient_normals(ns_raw, ng_raw, wo):
    """Normalize + flip shading/geometric normals to the wo hemisphere
    (reference: src/traverse.cuh:192-206)."""
    ng = normalize(ng_raw)
    ns = normalize(ns_raw)
    flip = jnp.sign(dot(ng, wo))[..., None]
    flip = jnp.where(flip == 0.0, 1.0, flip)
    ng = ng * flip
    ns = ns * jnp.sign(dot(ns, ng))[..., None]
    ns = jnp.where(dot(ns, wo)[..., None] > 0.0, ns, ng)
    return ns, ng


def _fetch_surface(scene: SceneData, tri, u, v, wo):
    """Per-hit surface fetch: interpolated shading normal, geometric normal
    and material id of the hit triangle."""
    t = jnp.maximum(tri, 0)
    nc = [scene.tri_nrm_t[k][t] for k in range(9)]
    n0 = jnp.stack(nc[0:3], axis=-1)
    n1 = jnp.stack(nc[3:6], axis=-1)
    n2 = jnp.stack(nc[6:9], axis=-1)
    w = 1.0 - u - v
    ns_raw = w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2
    vc = [scene.bvh.tris_t[k][t] for k in range(9)]
    v0 = jnp.stack(vc[0:3], axis=-1)
    v1 = jnp.stack(vc[3:6], axis=-1)
    v2 = jnp.stack(vc[6:9], axis=-1)
    ng_raw = jnp.cross(v1 - v0, v2 - v0)
    mat = scene.tri_mat[t]
    return ns_raw, ng_raw, mat


def _material_at(scene: SceneData, mat, pos, ns, cone_width,
                 use_proctex: bool):
    """Resolve material params; textured materials get procedural soil
    shading (analytic, zero-gather) or the legacy mip/triplanar path."""
    mtype, albedo, rough, ior, f0, emission, textured = material_lookup(
        scene.materials, mat)

    if use_proctex:
        tex_alb, tex_rough, ns_tex = soil_shading(pos, ns, cone_width)
    else:
        tex_a = triplanar_sample(scene.textures.albedo_ao, pos, ns, cone_width)
        tex_nr = triplanar_sample(scene.textures.normal_rough, pos, ns,
                                  cone_width)
        tex_alb = tex_a[..., 0:3] * tex_a[..., 3:4]
        tex_rough = tex_nr[..., 3]
        ns_tex = apply_normal_map(ns, tex_nr[..., 0:3])

    albedo = jnp.where(textured[..., None], albedo * tex_alb, albedo)
    rough = jnp.where(textured, tex_rough, rough)
    ns2 = jnp.where(textured[..., None], ns_tex, ns)
    return mtype, albedo, rough, ior, f0, emission, ns2


def path_trace(scene: SceneData, rays: Rays, pixel_ids, frame_idx,
               prev_basis: CameraBasis, aspect,
               max_steps: int = 1024, trace: str = "xla",
               use_proctex: bool = True, bn=None, env_fn=None,
               leaf_width: int = 1, mesh=None) -> GBuffer:
    """Trace the full bounce program for all rays; returns the G-buffer.

    bn: optional (N,2) blue-noise CP offsets (sampling.blue_offsets_flat) —
    switches sampling to the shared-sequence blue-noise-dithered mode
    (reference: src/blueNoiseRandGen.h inter-pixel distribution).
    env_fn: optional (org, dir) -> (...,3) escape-environment override
    (render/environment.py composes sky + ocean + stars); default is the
    plain Chebyshev sky fit.
    trace: "kernel" | "xla" — the traversal (bvh/lane_traverse.intersect);
    mesh: optional 1-D row mesh the kernel is shard_mapped over."""
    n = rays.org.shape[0]
    f3 = lambda: jnp.zeros((n, 3), jnp.float32)

    state = dict(
        org=rays.org, dir=rays.dir,
        beta=jnp.ones((n, 3), jnp.float32),        # path throughput
        radiance=f3(),
        done=jnp.zeros((n,), bool),
        is_shadow=jnp.zeros((n,), bool),
        pending=f3(),                              # shadow contribution
        shadow_tmax=jnp.full((n,), jnp.inf),
        prev_pdf=jnp.zeros((n,), jnp.float32),
        prev_delta=jnp.ones((n,), bool),
        inside=jnp.zeros((n,), bool),
        cone=rays.cone_width,
        # deferred environment escape (evaluated once after the loop)
        esc_dir=rays.dir,
        esc_beta=f3(),
        esc_pdf=jnp.zeros((n,), jnp.float32),
        esc_delta=jnp.ones((n,), bool),
        has_esc=jnp.zeros((n,), bool),
        # G-buffer
        albedo=jnp.ones((n, 3), jnp.float32),
        normal=f3(),
        depth=jnp.full((n,), jnp.inf),
        mat_id=jnp.full((n,), -1, jnp.int32),
        got_primary=jnp.zeros((n,), bool),
    )

    for seg in range(SEGMENTS):
        state = _segment(scene, state, pixel_ids, frame_idx, seg, max_steps,
                         is_last=(seg == SEGMENTS - 1), trace=trace,
                         use_proctex=use_proctex, bn=bn,
                         leaf_width=leaf_width, mesh=mesh)

    # ---- deferred environment resolve: ONE analytic eval for all lanes ----
    env = (env_fn(rays.org, state["esc_dir"]) if env_fn is not None
           else env_radiance_fit(scene.sky, state["esc_dir"]))
    lpdf = sun_pdf_dir(scene.sky, state["esc_dir"])  # NEE covers sun only
    w_env = jnp.where(state["esc_delta"], 1.0,
                      power_heuristic(1.0, state["esc_pdf"], 1.0, lpdf))
    state["radiance"] = state["radiance"] + jnp.where(
        state["has_esc"][..., None],
        state["esc_beta"] * env * w_env[..., None], 0.0)

    # demodulated color (reference: albedo decouple at pathtrace.cuh:121)
    safe_albedo = jnp.maximum(state["albedo"], 1e-3)
    color = jnp.clip(state["radiance"], 0.0, RADIANCE_CLAMP) / safe_albedo

    mv = motion_vector(prev_basis, rays.uv,
                       rays.org + rays.dir
                       * jnp.minimum(state["depth"], 1e8)[..., None],
                       aspect)
    return GBuffer(color=color, albedo=state["albedo"], normal=state["normal"],
                   depth=state["depth"], motion=mv, mat_id=state["mat_id"])


def _segment(scene: SceneData, s, pixel_ids, frame_idx, seg, max_steps,
             is_last, trace="xla", use_proctex=True, bn=None, leaf_width=1,
             mesh=None):
    active = ~s["done"]
    t_max = jnp.where(s["done"], 0.0,
                      jnp.where(s["is_shadow"], s["shadow_tmax"], jnp.inf))
    hit = intersect(trace, scene.bvh, s["org"], s["dir"], t_max,
                    max_steps=max_steps, leaf_width=leaf_width, mesh=mesh)
    found = (hit.tri >= 0) & active

    # ---------------- shadow-ray resolution ----------------
    sh = s["is_shadow"] & active
    unoccluded = sh & ~(hit.tri >= 0)
    s["radiance"] = s["radiance"] + jnp.where(unoccluded[..., None],
                                              s["pending"], 0.0)
    s["done"] = s["done"] | sh  # shadow ray ends the path either way

    # ---------------- analytic sphere-light hits (scatter rays) -----------
    # (reference: RENDER_SPHERE_LIGHT path, src/light.cuh:240-270 — lights
    # are analytic spheres, tested per segment against the current ray)
    if scene.lights is not None:
        nl = scene.lights.center.shape[0]
        lt = jnp.full(s["dir"].shape[:-1], jnp.inf)
        lem = jnp.zeros_like(s["beta"])
        for li in range(nl):
            hl, tl = ray_sphere(s["org"], s["dir"], scene.lights.center[li],
                                scene.lights.radius[li])
            closer = hl & (tl < lt)
            lt = jnp.where(closer, tl, lt)
            lem = jnp.where(closer[..., None], scene.lights.emission[li], lem)
        # light hit counts when nearer than geometry and the ray is a live
        # scatter ray (shadow rays to the SUN may pass through; sphere-light
        # NEE uses finite t_max so occlusion semantics stay correct)
        lhit = active & ~sh & (lt < hit.t)
        lpdf_sphere = _sphere_lights_pdf(scene.lights, s["org"], s["dir"], lt)
        w_l = jnp.where(s["prev_delta"], 1.0,
                        power_heuristic(1.0, s["prev_pdf"], 1.0,
                                        0.5 * lpdf_sphere))
        s["radiance"] = s["radiance"] + jnp.where(
            lhit[..., None], s["beta"] * lem * w_l[..., None], 0.0)
        s["done"] = s["done"] | lhit

    # ---------------- escaped scatter rays: defer env to the end ----------
    esc = active & ~sh & ~(hit.tri >= 0)
    s["esc_dir"] = jnp.where(esc[..., None], s["dir"], s["esc_dir"])
    s["esc_beta"] = jnp.where(esc[..., None], s["beta"], s["esc_beta"])
    s["esc_pdf"] = jnp.where(esc, s["prev_pdf"], s["esc_pdf"])
    s["esc_delta"] = jnp.where(esc, s["prev_delta"], s["esc_delta"])
    s["has_esc"] = s["has_esc"] | esc
    s["done"] = s["done"] | esc

    live = found & ~sh & ~s["done"]
    if is_last:
        s["done"] = s["done"] | live
        return s

    # ---------------- surface interaction ----------------
    wo = -s["dir"]
    pos = s["org"] + s["dir"] * hit.t[..., None]
    cone_w = s["cone"] * hit.t
    ns_raw, ng_raw, mat = _fetch_surface(scene, hit.tri, hit.u, hit.v, wo)
    ns, ng = _orient_normals(ns_raw, ng_raw, wo)
    mtype, albedo, rough, ior, f0, emission, ns = _material_at(
        scene, mat, pos, ns, cone_w, use_proctex)

    # emissive surfaces add radiance and terminate (reference: light-source
    # hits resolve through GetLightSource; NEE never samples mesh emitters so
    # the weight is 1)
    emissive = live & (mtype == MAT_EMISSIVE)
    s["radiance"] = s["radiance"] + jnp.where(
        emissive[..., None], s["beta"] * emission, 0.0)
    s["done"] = s["done"] | emissive
    live = live & ~emissive

    # primary-hit G-buffer capture (reference: pathtrace.cuh:123-127)
    first = live & ~s["got_primary"]
    s["normal"] = jnp.where(first[..., None], ns, s["normal"])
    s["depth"] = jnp.where(first, hit.t, s["depth"])
    s["mat_id"] = jnp.where(first, mat, s["mat_id"])
    s["albedo"] = jnp.where(first[..., None], jnp.maximum(albedo, 1e-3),
                            s["albedo"])
    s["got_primary"] = s["got_primary"] | live

    # low-discrepancy dims for this bounce (measured: swapping deep-bounce
    # dims to white noise does NOT change frame time — XLA hides the bit
    # mixing — so keep full LD quality everywhere)
    from .sampling import rand2_bn
    ld2 = ((lambda d: rand2_bn(bn, frame_idx, d)) if bn is not None
           else (lambda d: rand2(pixel_ids, frame_idx, d)))
    u_bsdf = ld2(jnp.uint32(2 + 2 * seg))
    u_light = ld2(jnp.uint32(64 + 2 * seg))
    u_aux = ld2(jnp.uint32(128 + 2 * seg))
    u_sel = u_aux[..., 0]

    bs = sample_bsdf(mtype, albedo, rough, ior, f0, ns, wo, s["inside"], u_bsdf)
    rough_lane = live & ~bs.is_delta

    # --- light sample + MIS (rough surfaces only): analytic sun NEE,
    # 50/50 mixed with sphere-light NEE when local lights exist ---
    ls = sample_sun(scene.sky, u_light)
    if scene.lights is not None:
        nl = scene.lights.center.shape[0]
        pick = ld2(jnp.uint32(192 + 2 * seg))
        li = jnp.clip((pick[..., 0] * nl).astype(jnp.int32), 0, nl - 1)
        lsp = sample_sphere_light(scene.lights, li, pos, u_light)
        use_sphere = pick[..., 1] < 0.5
        ls = ls._replace(
            wi=jnp.where(use_sphere[..., None], lsp.wi, ls.wi),
            radiance=jnp.where(use_sphere[..., None], lsp.radiance,
                               ls.radiance),
            pdf=jnp.where(use_sphere, 0.5 * lsp.pdf / nl, 0.5 * ls.pdf),
            dist=jnp.where(use_sphere, lsp.dist, ls.dist))
    f_l, pdf_b_at_l = eval_bsdf(mtype, albedo, rough, f0, ns, wo, ls.wi)
    cos_l = jnp.maximum(dot(ns, ls.wi), 0.0)
    w_l = power_heuristic(1.0, ls.pdf, 1.0, pdf_b_at_l)
    c_light = s["beta"] * f_l * (cos_l / jnp.maximum(ls.pdf, 1e-8))[..., None] \
        * ls.radiance * w_l[..., None]
    c_light = jnp.where((ls.pdf > 1e-8)[..., None], c_light, 0.0)

    # --- stochastic single-ray selection (reference trick) ---
    lum = lambda c: jnp.sum(c * jnp.array([0.2126, 0.7152, 0.0722]), axis=-1)
    est_l = lum(c_light)
    est_s = lum(s["beta"] * bs.weight)
    q = jnp.where(est_l + est_s > 0.0,
                  est_l / jnp.maximum(est_l + est_s, 1e-12), 0.0)
    q = jnp.clip(q, 0.0, 0.9)
    take_shadow = rough_lane & (u_sel < q) & (est_l > 0.0)

    # shadow-ray branch: contribution scaled by 1/q
    s["is_shadow"] = jnp.where(take_shadow, True, False)
    s["pending"] = jnp.where(take_shadow[..., None],
                             c_light / jnp.maximum(q, 1e-3)[..., None], 0.0)
    s["shadow_tmax"] = jnp.where(take_shadow, ls.dist, jnp.inf)

    # scatter branch (delta lanes always scatter)
    scatter = live & ~take_shadow
    inv_p = jnp.where(rough_lane, 1.0 / jnp.maximum(1.0 - q, 1e-3), 1.0)
    new_beta = s["beta"] * bs.weight * inv_p[..., None]
    s["beta"] = jnp.where(scatter[..., None], new_beta, s["beta"])
    s["prev_pdf"] = jnp.where(scatter, bs.pdf, s["prev_pdf"])
    s["prev_delta"] = jnp.where(scatter, bs.is_delta, s["prev_delta"])

    # glass transmission flips inside-ness when crossing the surface
    crossed = scatter & (dot(bs.wi, ng) < 0.0)
    s["inside"] = jnp.where(crossed, ~s["inside"], s["inside"])

    new_dir = jnp.where(take_shadow[..., None], ls.wi, bs.wi)
    off = jnp.where((dot(new_dir, ng) >= 0.0)[..., None], ng * 1e-3, -ng * 1e-3)
    s["org"] = jnp.where(live[..., None], pos + off, s["org"])
    s["dir"] = jnp.where(live[..., None], new_dir, s["dir"])
    s["cone"] = jnp.where(live, cone_w, s["cone"])

    # dead throughput terminates the lane
    s["done"] = s["done"] | (live & ~take_shadow & (lum(s["beta"]) < 1e-5))
    return s
