"""Command-line renderer mirroring the reference CLI (examples/cli.rs).

Global flags: scene file, -n/--nbsamples, -a/--average ('inf' supported),
-t/--threads (maps to device count), -r/--random-number-generator,
-s/--scale-image, -e/--equal-time, -o/--output, -m/--medium "s[:a[:g]]",
-l/--log, -x/--xtra-options {ats,no-shading,hvs-light,texture-light};
one subcommand per integrator with the reference's own flags.

Usage: python -m rustlight_tpu.cli scene.xml -n 64 -o out.exr path -m 8
"""
from __future__ import annotations

import argparse
import logging
import sys
import time


def _inf_or(s, conv=int):
    """'inf' sentinel parsing (reference match_infinity, cli.rs:31-39)."""
    if s is None or s == "inf":
        return None
    return conv(s)


def _add_path_length(p):
    p.add_argument("-m", "--max-depth", default="inf")
    p.add_argument("-n", "--min-depth", default="0")
    p.add_argument("-r", "--rr-depth", default="0")


def _add_recons(p):
    p.add_argument("-i", "--iterations", type=int, default=50)
    p.add_argument("--strategy-recons", default="uniform",
                   choices=["uniform", "weighted", "bagging"])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rustlight_tpu",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("scene", help="scene file (.pbrt/.xml/.obj) or a "
                    "builtin: cbox, veach_mis, door_box")
    ap.add_argument("-n", "--nbsamples", type=int, default=1)
    ap.add_argument("-a", "--average", default=None,
                    help="averaging passes or time budget ('inf' / '10s')")
    ap.add_argument("--progress", action="store_true",
                    help="in-place per-pass progress bar on stderr under "
                         "-a/-e (reference `progress-bar` feature)")
    ap.add_argument("--resume", action="store_true",
                    help="continue -a averaging from the newest "
                         "<output>_<k>.pfm dump (bit-exact vs an "
                         "uninterrupted run; beyond-reference)")
    ap.add_argument("--adaptive", action="store_true",
                    help="variance-adaptive sampling: a pilot quarter of -n "
                         "measures per-pixel noise, the rest of the budget "
                         "concentrates on noisy pixels (beyond-reference; "
                         "per-pixel MC integrators, single render only)")
    ap.add_argument("--guiding", action="store_true",
                    help="path guiding: per-voxel directional radiance "
                         "histograms learned online, sampled as a defensive "
                         "bsdf/guide MIS mixture (beyond-reference; "
                         "IntegratorPathTracing, single render only)")
    ap.add_argument("--aovs", action="store_true",
                    help="also write every AOV buffer as "
                         "<output>_<name>.<ext> (film dump_all — gradient "
                         "integrators emit very_direct/gradient_x/gradient_y)")
    ap.add_argument("--feature-aovs", action="store_true",
                    help="add denoiser guide channels (first-hit "
                         "albedo/normal/depth, anti-aliased) to the film; "
                         "write them with --aovs (beyond-reference)")
    ap.add_argument("--profile", metavar="OUT.json", default=None,
                    help="write per-phase wall-clock timings (scene "
                         "compile, render, save) + run metadata as JSON "
                         "(structured form of the reference's Elapsed "
                         "log spans, integrators/mod.rs:324-334)")
    ap.add_argument("-t", "--threads", type=int, default=None,
                    help="device count to shard over (default: all)")
    ap.add_argument("-r", "--random-number-generator", default="independent",
                    help="independent[:seed] | stratified")
    ap.add_argument("-s", "--scale-image", type=float, default=1.0)
    ap.add_argument("-e", "--equal-time", type=float, default=None,
                    help="render-time budget in MILLISECONDS, matching the "
                         "reference -e (equal_time.rs:5)")
    ap.add_argument("-o", "--output", default="out.pfm")
    ap.add_argument("-m", "--medium", default="0.0",
                    help="sigma_s[:sigma_a[:g]] for an infinite homogeneous medium")
    ap.add_argument("-l", "--log", default=None)
    ap.add_argument("-x", "--xtra-options", action="append", default=[],
                    choices=["ats", "no-shading", "hvs-light", "texture-light"])

    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("ao")
    p.add_argument("-d", "--distance", default="1.0")
    p.add_argument("-c", "--normal-correction", action="store_true")

    p = sub.add_parser("direct")
    p.add_argument("-b", "--nb-bsdf-samples", type=int, default=1)
    p.add_argument("-l", "--nb-light-samples", type=int, default=1)

    p = sub.add_parser("path")
    _add_path_length(p)
    p.add_argument("-x", "--single-scattering", action="store_true")
    p.add_argument("-s", "--strategy", default="all",
                   choices=["all", "bsdf", "emitter", "naive"])

    p = sub.add_parser("light-tracing", aliases=["light"])
    _add_path_length(p)
    p.add_argument("-s", "--strategy", default="all",
                   choices=["all", "surface", "volume"])

    p = sub.add_parser("vpl")
    _add_path_length(p)
    p.add_argument("-b", "--clamping", type=float, default=0.0)
    p.add_argument("-n2", "--nb-vpl", type=int, default=128)

    p = sub.add_parser("vol-primitivies", aliases=["vol-primitives"])
    _add_path_length(p)
    p.add_argument("-n2", "--nb-primitive", type=int, default=128)
    p.add_argument("-p", "--primitives", default="BRE",
                   choices=["BRE", "Beams", "Planes", "VRL",
                            "bre", "beams", "planes", "vrl"])

    p = sub.add_parser("plane-single")
    p.add_argument("-n2", "--nb-primitive", type=int, default=128)
    p.add_argument("-s", "--strategy", default="average",
                   choices=["uv", "ut", "vt", "average", "discrete_mis",
                            "ualpha", "cmis"])

    p = sub.add_parser("uncorrelated-plane-single")
    p.add_argument("-n2", "--nb-primitive", type=int, default=128)
    p.add_argument("-s", "--strategy", default="average",
                   choices=["uv", "ut", "vt", "average", "discrete_mis",
                            "ualpha", "cmis"])

    p = sub.add_parser("point-normal")
    p.add_argument("-k", "--splitting", type=float, default=None)
    p.add_argument("-x", "--use-mis", action="store_true")
    p.add_argument("-z", "--disable-aa", action="store_true")
    p.add_argument("-s", "--strategy", default="tr_ex")
    p.add_argument("-w", "--warps", default="T",
                   help="warp chain chars from {T,P,N} (cli.rs -w)")
    p.add_argument("-W", "--warps-strategy", default="L",
                   choices=["L", "B"], help="Linear | Bezier wrap")

    p = sub.add_parser("gradient-path")
    _add_path_length(p)
    _add_recons(p)

    p = sub.add_parser("gradient-path-explicit")
    _add_path_length(p)
    _add_recons(p)
    p.add_argument("--min-survival", type=float, default=1.0)

    p = sub.add_parser("pssmlt")
    _add_path_length(p)
    p.add_argument("-s", "--strategy", default="all")
    p.add_argument("-p", "--large-prob", type=float, default=0.3)
    p.add_argument("-b", "--nb-samples-norm", type=int, default=100000)

    p = sub.add_parser("erpt")
    _add_path_length(p)
    p.add_argument("-k", "--stratified", action="store_true")
    p.add_argument("-s", "--strategy", default="all")
    p.add_argument("-e2", "--nb-mc", type=int, default=1)
    p.add_argument("-c", "--chain-samples", type=int, default=100)

    p = sub.add_parser("smcmc")
    _add_path_length(p)
    p.add_argument("-s", "--strategy", default="all")
    p.add_argument("-p", "--large-prob", type=float, default=0.3)
    p.add_argument("--recons-smcmc", default="irls")
    p.add_argument("--init", default="mcmc")
    return ap


def load_scene_arg(args):
    from .models import cornell_box
    from .scene.loaders import load_scene

    if args.scene == "cbox":
        scene = cornell_box()
    elif args.scene == "veach_mis":
        from .models.veach import veach_mis
        scene = veach_mis()
    elif args.scene == "door_box":
        from .models import door_box
        scene = door_box()
    else:
        scene = load_scene(args.scene)
    # image scale -s (reference Camera::scale_image): the sample-space mapping
    # is resolution independent, so only the pixel grid changes
    if args.scale_image != 1.0:
        cam = scene.camera
        scene.camera = cam.replace(
            width=int(cam.width * args.scale_image),
            height=int(cam.height * args.scale_image))
    # medium -m sigma_s[:sigma_a[:g]]
    parts = str(args.medium).split(":")
    sigma_s = float(parts[0])
    if sigma_s > 0.0:
        from .scene import make_volume
        sigma_a = float(parts[1]) if len(parts) > 1 else 0.0
        g = float(parts[2]) if len(parts) > 2 else 0.0
        scene.volume = make_volume(sigma_s=(sigma_s,) * 3,
                                   sigma_a=(sigma_a,) * 3, g=g)
    # -x hvs-light / texture-light: override light emission kinds
    # (reference cli.rs:409-429; scale = luminance of the original color)
    hsv = "hvs-light" in args.xtra_options
    tex = "texture-light" in args.xtra_options
    if hsv or tex:
        import numpy as np
        lum = np.array([0.212671, 0.715160, 0.072169], np.float32)
        tex_id = -1
        if tex:
            try:  # the reference hardcodes butterfly.jpg from the cwd
                from .utils import image as rimage
                img = np.asarray(rimage.load("butterfly.jpg"), np.float32)
            except Exception:
                # procedural fallback: smooth two-color ramp
                yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 63.0
                img = np.stack([xx, yy, 0.5 * (1 - xx)], -1)
            if scene.textures is None:
                scene.textures = img[None]
            else:
                th = max(scene.textures.shape[1], img.shape[0])
                tw = max(scene.textures.shape[2], img.shape[1])
                def pad(a):
                    out = np.zeros((a.shape[0], th, tw, 3), np.float32)
                    out[:, :a.shape[1], :a.shape[2]] = a
                    return out
                scene.textures = np.concatenate([pad(scene.textures),
                                                 pad(img[None])], 0)
            tex_id = scene.textures.shape[0] - 1
        for m in scene.meshes:
            if m.is_light:
                m.emission_scale = float((m.emission * lum).sum()) or 1.0
                m.emission_kind = 1 if hsv else 2
                m.emission_tex = tex_id
    return scene


def build_integrator(args):
    from . import integrators as I

    cmd = args.command
    if cmd == "ao":
        return I.IntegratorAO(max_distance=_inf_or(args.distance, float),
                              normal_correction=args.normal_correction)
    if cmd == "direct":
        return I.IntegratorDirect(args.nb_bsdf_samples, args.nb_light_samples)
    pl = dict(
        min_depth=_inf_or(getattr(args, "min_depth", "0")),
        max_depth=_inf_or(getattr(args, "max_depth", "inf")),
        rr_depth=_inf_or(getattr(args, "rr_depth", "0")),
    )
    if cmd == "path":
        return I.IntegratorPathTracing(strategy=args.strategy,
                                       single_scattering=args.single_scattering,
                                       **pl)
    if cmd in ("light-tracing", "light"):
        return I.IntegratorLightTracing(
            max_depth=pl["max_depth"], min_depth=pl["min_depth"],
            rr_depth=pl["rr_depth"],
            render_surface=args.strategy in ("all", "surface"),
            render_volume=args.strategy in ("all", "volume"))
    if cmd == "vpl":
        return I.IntegratorVPL(nb_vpl=args.nb_vpl, max_depth=pl["max_depth"],
                               rr_depth=pl["rr_depth"],
                               clamping_factor=args.clamping or None)
    if cmd in ("vol-primitivies", "vol-primitives"):
        return I.IntegratorVolPrimitives(
            nb_primitive=args.nb_primitive, max_depth=pl["max_depth"],
            rr_depth=pl["rr_depth"], primitives=args.primitives.lower())
    if cmd in ("plane-single", "uncorrelated-plane-single"):
        # strategy names from cli.rs:640-655
        strat = {"discrete_mis": "dmis", "ualpha": "ualpha"}.get(
            args.strategy, args.strategy)
        return I.IntegratorSinglePlane(
            nb_primitive=args.nb_primitive, strategy=strat,
            uncorrelated=cmd.startswith("uncorrelated"))
    if cmd == "point-normal":
        # strategy names mirror examples/cli.rs:455-494
        connection = "phase" if args.strategy.endswith("_phase") else "ex"
        phase_map = {
            "eq_phase": ("equiangular",),
            "tr_phase": ("tr",),
            "eq_clamped_phase": ("eq_clamp",),
        }
        strategies = {
            "tr_ex": ("tr", "equiangular"),
            "tr": ("tr",),
            "ex": ("equiangular",),
            "eq_ex": ("equiangular",),
            "ex_clamp": ("eq_clamp",),
            "eq_clamped_ex": ("eq_clamp",),
            "eq_warp_ex": ("warp",),
            "eq_tr_taylor_ex": ("taylor_tr",),
            "eq_phase_taylor_ex": ("taylor_phase",),
            "pn_ex": ("pn",),
            "eq_best_ex": ("best",),
            "pn_best_ex": ("pn_best",),
            "pn_warp_ex": ("pn", "warp"),
            "pn_tr_taylor_ex": ("pn_taylor_tr",),
            "pn_phase_taylor_ex": ("pn_taylor_phase",),
            "all": ("tr", "equiangular", "eq_clamp"),
        }.get(args.strategy)
        if strategies is None:
            strategies = phase_map.get(args.strategy, ("tr", "equiangular"))
        return I.IntegratorPointNormal(
            strategies=strategies, splitting=args.splitting,
            warps=args.warps, use_aa=not args.disable_aa,
            connection=connection,
            warps_strategy="bezier" if args.warps_strategy == "B" else "linear")
    if cmd == "gradient-path":
        # reconnection shift (src/integrators/gradient/path.rs)
        from .integrators.gradient import IntegratorGradientPathReconnect
        return IntegratorGradientPathReconnect(
            max_depth=pl["max_depth"], min_depth=pl.get("min_depth"),
            recons=args.strategy_recons, recons_iterations=args.iterations)
    if cmd == "gradient-path-explicit":
        # random-replay shift (src/integrators/gradient/explicit.rs)
        from .integrators.gradient import IntegratorGradientPath
        return IntegratorGradientPath(
            max_depth=pl["max_depth"], recons=args.strategy_recons,
            recons_iterations=args.iterations,
            min_survival=getattr(args, "min_survival", None))
    if cmd == "pssmlt":
        from .integrators.mcmc import IntegratorPSSMLT
        inner = I.IntegratorPathTracing(strategy=args.strategy, **pl)
        return IntegratorPSSMLT(inner, large_prob=args.large_prob,
                                nb_samples_norm=args.nb_samples_norm)
    if cmd == "erpt":
        from .integrators.mcmc import IntegratorERPT
        inner = I.IntegratorPathTracing(strategy=args.strategy, **pl)
        return IntegratorERPT(inner, nb_mc=args.nb_mc,
                              chain_samples=args.chain_samples,
                              stratified=args.stratified)
    if cmd == "smcmc":
        from .integrators.mcmc import IntegratorSMCMC
        inner = I.IntegratorPathTracing(strategy=args.strategy, **pl)
        # under -a, chains persist across passes and each pass returns the
        # cumulative reconstruction (avg REPLACES, smcmc.rs:1187-1212)
        return IntegratorSMCMC(inner, large_prob=args.large_prob,
                               recons=args.recons_smcmc, init=args.init,
                               keep_chains=args.average is not None)
    raise SystemExit(f"unknown command {cmd}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(levelname)s %(module)s - %(message)s",
        **({"filename": args.log} if args.log else {}))
    log = logging.getLogger("rustlight_tpu")

    t0 = time.time()
    scene = load_scene_arg(args)
    sd = scene.compile(use_ats="ats" in args.xtra_options,
                       use_shading_normals="no-shading" not in args.xtra_options)
    t_compile = time.time() - t0
    log.info("Scene compiled: %d triangles", sd.geom.n_tris)

    integrator = build_integrator(args)
    from .integrators import render, render_splat, SplattingIntegrator
    from .integrators.meta import IntegratorAverage, IntegratorEqualTime, _render_once

    seed = 0
    rng = args.random_number_generator
    if rng.startswith("independent:"):
        seed = int(rng.split(":")[1])
    sampler = "stratified" if rng.startswith("stratified") else "independent"

    # -t: shard the render over a device mesh (the reference's rayon pool
    # size, integrators/mod.rs:452-459; here devices are the parallel unit)
    mesh = None
    if args.threads is not None and args.threads > 1:
        import jax
        from .parallel import make_device_mesh
        n_dev = min(args.threads, len(jax.devices()))
        if n_dev > 1:
            mesh = make_device_mesh(n_dev)
            log.info("Sharding over %d devices (-t %d)", n_dev, args.threads)

    t1 = time.time()
    if args.guiding and (args.average is not None
                         or args.equal_time is not None):
        # under -a/-e the guide table PERSISTS across passes: each pass
        # keeps training the table the previous ones built (and -a dumps
        # checkpoint it, so --resume continues bit-exactly)
        from .integrators import IntegratorPathTracing
        from .integrators.guiding import IntegratorGuidedPath
        if not type(integrator) is IntegratorPathTracing:
            raise SystemExit("--guiding needs the `path` integrator")
        integrator = IntegratorGuidedPath(integrator)
        log.info("Guided path tracing: table persists across passes")
    if args.equal_time is not None:
        # -e is MILLISECONDS like the reference (equal_time.rs:5)
        meta = IntegratorEqualTime(integrator, target_s=args.equal_time / 1e3,
                                   spp_per_pass=args.nbsamples, mesh=mesh,
                                   progress=args.progress)
        film = meta.render(sd, seed=seed, verbose=True)
        log.info("Achieved spp: %d", meta.achieved_spp)
    elif args.average is not None:
        dump_base = args.output.rsplit(".", 1)[0]
        kw = dict(spp_per_pass=args.nbsamples, dump_base=dump_base,
                  mesh=mesh, resume=args.resume, progress=args.progress)
        if args.average == "inf":
            # run forever, dumping each pass (avg.rs:21); the dumps are the
            # de-facto checkpoints — stop with Ctrl-C and keep the last one
            # (and continue it later with --resume)
            meta = IntegratorAverage(integrator, **kw)
        elif args.average.endswith("s"):
            meta = IntegratorAverage(integrator,
                                     timeout_s=float(args.average[:-1]), **kw)
        else:
            meta = IntegratorAverage(integrator,
                                     nb_passes=int(args.average), **kw)
        try:
            film = meta.render(sd, seed=seed, verbose=True)
        except KeyboardInterrupt:
            if meta.infinite and meta.dump_base:
                log.info("interrupted; last dump kept at %s_<n>.pfm",
                         meta.dump_base)
            raise
    elif args.guiding:
        from .integrators import IntegratorPathTracing
        from .integrators.guiding import render_guided
        if not type(integrator) is IntegratorPathTracing:
            raise SystemExit("--guiding needs the `path` integrator")
        film = render_guided(sd, integrator, args.nbsamples, seed,
                             verbose=True, mesh=mesh)
    elif args.adaptive:
        from .integrators.common import SplattingIntegrator, render_adaptive
        if (isinstance(integrator, SplattingIntegrator)
                or hasattr(integrator, "render")):
            ap_err = ("--adaptive needs a per-pixel MC integrator "
                      "(path/ao/direct/...); splatting and self-driving "
                      "integrators allocate their own budgets")
            raise SystemExit(ap_err)
        film = render_adaptive(sd, integrator, args.nbsamples, seed,
                               verbose=True, mesh=mesh)
    else:
        film = _render_once(sd, integrator, args.nbsamples, seed,
                            sampler=sampler, mesh=mesh)
    t_render = time.time() - t1
    log.info("Elapsed Integrator: %.3fs", t_render)

    if args.feature_aovs:
        from .integrators.common import render_feature_aovs
        film.buffers.update(render_feature_aovs(sd, spp=8, seed=seed))
        log.info("Feature AOVs rendered (albedo/normal/depth)")

    t2 = time.time()
    film.save(args.output)
    if args.aovs and len(film.buffers) > 1:
        film.dump_all(args.output)
        log.info("Wrote AOVs: %s", ", ".join(sorted(film.buffers)))
    log.info("Wrote %s (total %.3fs)", args.output, time.time() - t0)

    if args.profile:
        import json
        import jax
        with open(args.profile, "w") as f:
            json.dump({
                "scene_compile_s": round(t_compile, 4),
                "integrator_s": round(t_render, 4),
                "save_s": round(time.time() - t2, 4),
                "total_s": round(time.time() - t0, 4),
                "n_triangles": int(sd.geom.n_tris),
                "resolution": [sd.camera.width, sd.camera.height],
                "spp": args.nbsamples,
                "integrator": args.command,
                "backend": jax.default_backend(),
                "n_devices": len(jax.devices()),
            }, f, indent=1)
        log.info("Wrote profile %s", args.profile)


if __name__ == "__main__":
    main()
