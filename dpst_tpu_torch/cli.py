"""Command-line driver: `python -m dpst_tpu_torch --content C --style S`.

The port's counterpart of `dpst_tpu/cli.py`, with its flags, defaults and
printed lines: content/style paths, iteration count, the three loss
weights (α content, Γ style, λ regularization), similarity metric and
threshold, intermediate interval, init mode, and the extras (multi-scale
schedule, profiler, NaN checks, resume, NIMA auto-tuning, the Laplacian's
route, a directory as one batch, one image row-sharded).

Devices are where the two CLIs differ. The port runs on the CUDA card:
`--device N` names cuda:N, and with no card and no `--device` the CLI
exits with an error; it never carries on on the CPU unasked. `--device
cpu` runs the plain PyTorch path on the CPU (the JAX CLI's counterpart is
`JAX_PLATFORMS=cpu`), and `--spatial N` then takes a mesh of N repeated
CPU devices. `--content-dir` and `--autotune` split their pairs or
candidates over every CUDA device unless `--device` names one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def _device_flag(value: str):
    """`--device`: "cpu", or a CUDA device index."""
    return value if value == "cpu" else int(value)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpst_tpu_torch",
        description="automated deep photo style transfer on an NVIDIA GPU "
                    "(PyTorch and CUDA)")
    p.add_argument("--content", help="content image path")
    p.add_argument("--content-dir", default=None,
                   help="stylize EVERY image in this directory against "
                        "--style, as one batch split over the devices")
    p.add_argument("--style", required=True, help="style image path")
    p.add_argument("--output", default="result.png",
                   help="output image path (with --content-dir: an "
                        "output directory)")
    p.add_argument("--size", type=int, default=512,
                   help="working resolution (longest side; 0 = native)")
    p.add_argument("--preset", choices=("config1", "config2", "config3",
                                        "config4", "config5"),
                   default=None,
                   help="start from a BASELINE.md preset; explicitly "
                        "passed flags still override")

    g = p.add_argument_group("loss weights")
    g.add_argument("--content-weight", type=float, default=1.0)
    g.add_argument("--style-weight", type=float, default=100.0,
                   help="Γ; ignored when --autotune is set")
    g.add_argument("--regularization-weight", type=float, default=1e4,
                   help="λ on the matting-Laplacian photorealism term")
    g.add_argument("--tv-weight", type=float, default=0.0)
    g.add_argument("--style-norm", choices=("gatys", "paper"),
                   default="gatys",
                   help="style-loss normalization: 'paper' = reference-"
                        "exact 1/(2N²) per-class scale (docs/PARITY.md)")

    g = p.add_argument_group("optimization")
    g.add_argument("--iterations", type=int, default=500)
    g.add_argument("--optimizer", choices=("adam", "lbfgs"),
                   default="adam")
    g.add_argument("--lr", type=float, default=2.0)
    g.add_argument("--init", choices=("content", "noise", "style_mean"),
                   default="content")
    g.add_argument("--scales", type=int, nargs="*", default=None,
                   help="multi-scale schedule, e.g. --scales 256 512 1024")
    g.add_argument("--seed", type=int, default=0)

    g = p.add_argument_group("segmentation")
    g.add_argument("--no-segmentation", action="store_true",
                   help="disable automatic masks (plain Gram style loss)")
    g.add_argument("--similarity-metric",
                   choices=("grouped", "token", "combined", "embedding"),
                   default="grouped",
                   help="'embedding' uses a precomputed 150x150 matrix "
                        "asset ($DPST_SIMILARITY_MATRIX)")
    g.add_argument("--similarity-threshold", type=float, default=0.25)
    g.add_argument("--max-classes", type=int, default=8)
    g.add_argument("--seg-protocol", choices=("resize", "sliding"),
                   default="resize",
                   help="PSPNet inference protocol: 'sliding' = the "
                        "semseg-lineage eval (aspect-preserving + 473^2 "
                        "sliding windows + mirror; best mask quality "
                        "with real weights), 'resize' = one 473^2 "
                        "squash (fastest)")
    g.add_argument("--seg-scales", type=float, nargs="*", default=None,
                   help="multi-scale ensemble for --seg-protocol "
                        "sliding, e.g. --seg-scales 0.75 1.0 1.25")
    g.add_argument("--content-masks", default=None,
                   help=".npy (K,H,W) mask stack overriding segmentation")
    g.add_argument("--style-masks", default=None)

    g = p.add_argument_group("photorealism")
    g.add_argument("--no-photorealism", action="store_true")
    g.add_argument("--matting-epsilon", type=float, default=1e-5)
    g.add_argument("--laplacian-impl",
                   choices=("auto", "pallas", "xla", "spmd"),
                   default="auto",
                   help="the matting Laplacian's matvec: 'pallas' the CUDA "
                        "kernel, 'xla' plain PyTorch, 'spmd' split over "
                        "the rows of --spatial's mesh")
    g.add_argument("--post-smooth", type=int, default=0, metavar="RADIUS",
                   help="smooth-local-affine post-process window radius "
                        "(guided filter; 0 = off)")
    g.add_argument("--post-smooth-eps", type=float, default=1e-4)

    g = p.add_argument_group("parallelism")
    g.add_argument("--spatial", type=int, default=0, metavar="N",
                   help="row-shard the single image over the first N "
                        "CUDA devices (parallel/spatial.py; the high-"
                        "resolution regime where one card's memory is not "
                        "enough; with --device cpu, N CPU shards). Image "
                        "rows must divide N.")

    g = p.add_argument_group("auto-tuning (NIMA)")
    g.add_argument("--autotune", action="store_true",
                   help="choose Γ by maximizing the NIMA score")
    g.add_argument("--gamma-candidates", type=float, nargs="*",
                   default=None)
    g.add_argument("--tune-rounds", type=int, default=1)

    g = p.add_argument_group("observability / state")
    g.add_argument("--intermediate-interval", type=int, default=100)
    g.add_argument("--intermediate-dir", default=None,
                   help="save in-progress images here every interval")
    g.add_argument("--loss-csv", default=None,
                   help="write the per-step loss history as CSV")
    g.add_argument("--history-terms", choices=("auto", "full", "total"),
                   default="auto",
                   help="per-step loss detail; with lbfgs, 'full' costs "
                        "one extra VGG forward per step (auto = full "
                        "for adam, total for lbfgs)")
    g.add_argument("--metrics", action="store_true",
                   help="report SSIM/PSNR of the result vs the content "
                        "photo (structure-preservation proxy - the DPST "
                        "papers' photorealism axis)")
    g.add_argument("--checkpoint-dir", default=None)
    g.add_argument("--resume", action="store_true")
    g.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the run")
    g.add_argument("--debug-nans", action="store_true",
                   help="stop at the first non-finite loss or gradient")
    g.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="conv/Gram compute dtype")
    g.add_argument("--conv-impl",
                   choices=("auto", "pallas", "xla", "flipvjp", "padbwd",
                            "dotbwd", "dot11"),
                   default="auto",
                   help="VGG conv backend: 'pallas' the hand-written CUDA "
                        "conv3x3 kernel, else cuDNN")
    g.add_argument("--gram-impl",
                   choices=("auto", "pallas", "xla", "dotg", "stream",
                            "hybrid"),
                   default="auto", help="masked-Gram kernel backend")
    g.add_argument("--s2b-strips", type=int, default=-1,
                   help="the JAX package's space-to-batch of VGG blocks "
                        "1-2: -1 auto, 0 off, N strips (the port computes "
                        "the same math without it)")
    g.add_argument("--stream12", type=int, default=-1,
                   help="stream VGG blocks 1-2 strip-by-strip (the "
                        ">=3072^2 single-card memory path): -1 auto, "
                        "0 off, N strips")
    g.add_argument("--pool-impl",
                   choices=("auto", "pallas", "xla", "noties", "postact"),
                   default="auto", help="max-pool backward backend")
    g.add_argument("--block1-impl",
                   choices=("auto", "s2d", "conv"),
                   default="auto",
                   help="VGG block-1 route: with --s2d-gram pallas below "
                        "2^18 pixels, s2d sends conv1_1 to the fused "
                        "bias+ReLU Gram kernels")
    g.add_argument("--s2d-gram",
                   choices=("auto", "nd", "pallas"),
                   default="auto",
                   help="conv1_1's masked Gram: pallas takes the fused "
                        "bias+ReLU Gram kernels, nd (= auto) the "
                        "separate ones")
    g.add_argument("--remat",
                   choices=("none", "full", "block1", "block12"),
                   default="none",
                   help="rematerialize (all | block-1 | block-1+2) VGG "
                        "activations in the backward instead of storing "
                        "them")
    g.add_argument("--pooling", choices=("max", "avg"), default="max")
    g.add_argument("--no-compile-cache", action="store_true",
                   help="accepted and ignored: the CUDA kernels' build "
                        "directory (dpst_tpu_torch/_build) is the cache")
    g.add_argument("--device", type=_device_flag, default=None,
                   help="CUDA device index to run on (cuda:N; the "
                        "reference's GPU-id flag), or 'cpu' for the plain "
                        "PyTorch path on the CPU; default: the first CUDA "
                        "device")
    return p


def _explicit_dests(argv) -> set:
    """Dest names of flags literally present on the command line.

    A second parser with argparse.SUPPRESS defaults: absent flags leave no
    attribute, so a flag passed explicitly AT its default value is still
    detected (a value comparison could not tell `--preset config1 --dtype
    bfloat16` from the flag being absent)."""
    p = build_parser()
    for a in p._actions:
        a.default = argparse.SUPPRESS
        a.required = False
    ns, _ = p.parse_known_args(argv)
    return set(vars(ns))


# flag dest -> StylizeConfig field, for the flags a preset lets override
_FLAG_TO_FIELD = {
    "content_weight": "content_weight",
    "style_weight": "style_weight",
    "regularization_weight": "regularization_weight",
    "tv_weight": "tv_weight", "style_norm": "style_norm",
    "iterations": "iterations",
    "optimizer": "optimizer", "lr": "learning_rate",
    "init": "init_mode", "seed": "seed",
    "similarity_metric": "similarity_metric",
    "similarity_threshold": "similarity_threshold",
    "max_classes": "max_classes",
    "seg_protocol": "seg_protocol",
    "matting_epsilon": "matting_epsilon",
    "laplacian_impl": "laplacian_impl",
    "post_smooth": "post_smooth",
    "post_smooth_eps": "post_smooth_eps",
    "intermediate_interval": "intermediate_interval",
    "dtype": "compute_dtype", "pooling": "pooling",
    "conv_impl": "conv_impl", "gram_impl": "gram_impl",
    "pool_impl": "pool_impl", "remat": "remat",
    "s2b_strips": "s2b_strips",
    "stream12": "stream12",
    "block1_impl": "block1_impl",
    "s2d_gram": "s2d_gram",
    "history_terms": "history_terms",
}


def config_from_args(args, argv=None) -> "StylizeConfig":
    """The StylizeConfig of parsed flags: a preset with the flags passed
    explicitly (all of `argv`'s; without argv, those that differ from
    their defaults) laid over it, or the flags alone."""
    from .config import PRESETS, StylizeConfig

    if args.preset:
        base = PRESETS[args.preset]
        if argv is not None:
            explicit = _explicit_dests(argv)

            def was_set(flag):
                return flag in explicit
        else:
            # a programmatic call: a flag passed at its default value
            # cannot be told from an absent one
            defaults = build_parser().parse_args(
                ["--content", args.content, "--style", args.style])

            def was_set(flag):
                return getattr(args, flag) != getattr(defaults, flag)
        overrides = {field: getattr(args, flag)
                     for flag, field in _FLAG_TO_FIELD.items()
                     if was_set(flag)}
        if args.scales is not None:
            overrides["scales"] = tuple(args.scales)
        if args.seg_scales is not None:
            overrides["seg_scales"] = tuple(args.seg_scales)
        if args.no_segmentation:
            overrides["use_segmentation"] = False
        if args.no_photorealism:
            overrides["use_photorealism"] = False
        for field in ("checkpoint_dir", "profile_dir"):
            if getattr(args, field):
                overrides[field] = getattr(args, field)
        if args.debug_nans:
            overrides["debug_nans"] = True
        return dataclasses.replace(base, **overrides)

    return StylizeConfig(
        content_weight=args.content_weight,
        style_weight=args.style_weight,
        regularization_weight=args.regularization_weight,
        tv_weight=args.tv_weight,
        style_norm=args.style_norm,
        iterations=args.iterations,
        optimizer=args.optimizer,
        learning_rate=args.lr,
        init_mode=args.init,
        seed=args.seed,
        scales=tuple(args.scales) if args.scales else (),
        use_segmentation=not args.no_segmentation,
        similarity_metric=args.similarity_metric,
        similarity_threshold=args.similarity_threshold,
        max_classes=args.max_classes,
        seg_protocol=args.seg_protocol,
        seg_scales=(tuple(args.seg_scales) if args.seg_scales
                    else (1.0,)),
        use_photorealism=not args.no_photorealism,
        matting_epsilon=args.matting_epsilon,
        laplacian_impl=args.laplacian_impl,
        post_smooth=args.post_smooth,
        post_smooth_eps=args.post_smooth_eps,
        intermediate_interval=args.intermediate_interval,
        checkpoint_dir=args.checkpoint_dir or "",
        profile_dir=args.profile_dir or "",
        debug_nans=args.debug_nans,
        compute_dtype=args.dtype,
        pooling=args.pooling,
        conv_impl=args.conv_impl,
        gram_impl=args.gram_impl,
        pool_impl=args.pool_impl,
        s2b_strips=args.s2b_strips,
        stream12=args.stream12,
        block1_impl=args.block1_impl,
        s2d_gram=args.s2d_gram,
        remat=args.remat,
        history_terms=args.history_terms,
    )


def _device(flag):
    """The torch.device of `--device`: "cpu", cuda:N (range-checked), or,
    without the flag, the CUDA card (SystemExit where there is none)."""
    import torch

    from .utils import runtime

    if flag == "cpu":
        return torch.device("cpu")
    if flag is None:
        try:
            return runtime.canonical(runtime.resolve_device(None))
        except RuntimeError as err:
            raise SystemExit(f"dpst_tpu_torch: {err} (here: --device "
                             "cpu)") from None
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= flag < count:
        raise SystemExit(f"--device {flag} out of range: {count} device(s) "
                         "available")
    torch.cuda.set_device(flag)
    return torch.device("cuda", flag)


def _print_final(history) -> None:
    """The last history row, or its total where the history holds totals
    only (L-BFGS with history_terms="auto")."""
    import numpy as np

    if np.any(history[:, 1:]):
        print(f"final losses: total={history[-1, 0]:.4g} "
              f"content={history[-1, 1]:.4g} "
              f"style={history[-1, 2]:.4g} "
              f"photoreal={history[-1, 3]:.4g} "
              f"tv={history[-1, 4]:.4g}")
    else:
        # the per-term row costs L-BFGS an extra forward per step; opt back
        # in with --history-terms full
        print(f"final loss: total={history[-1, 0]:.4g} "
              "(per-term history off; --history-terms full)")


def _write_csv(path: str, history) -> None:
    import numpy as np

    np.savetxt(path, np.asarray(history), delimiter=",",
               header="total,content,style,photoreal,tv", comments="")
    print(f"wrote {path}")


def _load_pair_and_masks(args, cfg, size, device):
    """One pair at the working resolution and its aligned (K, H, W) masks:
    the .npy stacks given, else automatic segmentation on `device`, else
    one uniform class."""
    import numpy as np

    from . import segmentation
    from .api import _fit_masks
    from .utils import io

    content = io.load_image(args.content, size)
    hw = content.shape[:2]
    style = io.load_image(args.style, hw)
    if args.content_masks or args.style_masks:
        if not (args.content_masks and args.style_masks):
            raise SystemExit("--content-masks and --style-masks must be "
                             "given together (aligned class channels)")
        cmask = _fit_masks(np.load(args.content_masks).astype(np.float32),
                           hw)
        smask = _fit_masks(np.load(args.style_masks).astype(np.float32),
                           style.shape[:2])
    elif cfg.use_segmentation:
        cmask, smask, _ = segmentation.automatic_masks(content, style, cfg,
                                                       device=device)
    else:
        cmask = segmentation.uniform_masks(hw)
        smask = segmentation.uniform_masks(style.shape[:2])
    return content, style, cmask, smask


def _run_spatial(args, cfg, size, device) -> int:
    """--spatial N: one pair with its rows sharded over N devices (the
    first N CUDA devices; N CPU shards under --device cpu)."""
    import torch

    from .ops import metrics
    from .parallel.spatial import make_spatial_mesh, stylize_spatial
    from .utils import io

    n = args.spatial
    if device.type == "cpu":
        mesh_devices = ["cpu"] * n
    else:
        avail = torch.cuda.device_count()
        if n > avail:
            raise SystemExit(
                f"--spatial {n}: only {avail} device(s) available")
        mesh_devices = None
    content, style, cmask, smask = _load_pair_and_masks(args, cfg, size,
                                                        device)
    if content.shape[0] % n:
        raise SystemExit(
            f"--spatial {n}: image rows {content.shape[0]} must divide "
            f"the mesh (pick --size accordingly)")
    mesh = make_spatial_mesh(n, mesh_devices)
    t0 = time.perf_counter()
    out, history = stylize_spatial(content, style, cmask, smask, cfg=cfg,
                                   mesh=mesh)
    out, history = out.cpu().numpy(), history.cpu().numpy()
    dt = time.perf_counter() - t0
    io.save_image(out, args.output)
    print(f"wrote {args.output}  ({out.shape[1]}x{out.shape[0]}, "
          f"{dt:.1f}s, {n}-way row-sharded)")
    if args.metrics:
        print(f"vs content: SSIM={float(metrics.ssim(out, content)):.4f} "
              f"PSNR={float(metrics.psnr(out, content)):.2f} dB")
    if len(history):
        print(f"final losses: total={history[-1, 0]:.4g} "
              f"content={history[-1, 1]:.4g} style={history[-1, 2]:.4g} "
              f"photoreal={history[-1, 3]:.4g}")
        if args.loss_csv:
            _write_csv(args.loss_csv, history)
    return 0


def _run_batch_dir(args, cfg, size, device) -> int:
    """--content-dir: every image of a directory against one style, as one
    batch (BASELINE config 5 through the CLI), split over every CUDA
    device unless --device names one."""
    import glob

    import numpy as np

    from . import segmentation
    from .parallel.batch import stylize_batch
    from .utils import io

    exts = ("*.png", "*.jpg", "*.jpeg", "*.bmp", "*.webp")
    paths = sorted(p for e in exts
                   for p in glob.glob(os.path.join(args.content_dir, e)))
    if not paths:
        raise SystemExit(f"no images found in {args.content_dir}")
    hw = None
    contents = []
    for p in paths:
        img = io.load_image(p, size if size else 512)
        if hw is None:
            hw = img.shape[:2]
        elif img.shape[:2] != hw:
            img = io.load_image(p, hw)  # a batch takes one shape
        contents.append(img)
    contents = np.stack(contents)
    style = io.load_image(args.style, hw)
    styles = np.broadcast_to(style, contents.shape).copy()

    if cfg.use_segmentation:
        from .models import pspnet
        # one batched PSPNet forward for the contents, one for the style
        cmasks, smasks = segmentation.automatic_masks_batch(
            contents, style, cfg, pspnet.get_params(device=device),
            device=device)
    else:
        ones = segmentation.uniform_masks(hw)
        cmasks = np.broadcast_to(ones, (len(paths),) + ones.shape).copy()
        smasks = cmasks

    t0 = time.perf_counter()
    images, _ = stylize_batch(
        contents, styles, cmasks, smasks, cfg=cfg,
        device=device if args.device is not None else None)
    dt = time.perf_counter() - t0
    os.makedirs(args.output, exist_ok=True)
    for p, img, content in zip(paths, images, contents):
        io.save_image(img, os.path.join(args.output, os.path.basename(p)))
        if args.metrics:
            from .ops import metrics
            print(f"{os.path.basename(p)}: "
                  f"SSIM={float(metrics.ssim(img, content)):.4f} "
                  f"PSNR={float(metrics.psnr(img, content)):.2f} dB "
                  "(vs content)")
    print(f"stylized {len(paths)} images in {dt:.1f}s "
          f"({dt / len(paths):.1f}s/image) -> {args.output}/")
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.content and not args.content_dir:
        parser.error("one of --content / --content-dir is required")
    if args.laplacian_impl == "spmd" and not args.spatial:
        # outside a row-sharded mesh the split matvec has no mesh to split
        # over
        parser.error(
            "--laplacian-impl spmd needs a row-sharded mesh: use it "
            "with --spatial N (library path: parallel/spatial.py)")
    if args.spatial and (args.content_dir or args.autotune):
        parser.error(
            "--spatial shards ONE image over devices; it composes with "
            "neither --content-dir nor --autotune (those split the "
            "pair/candidate axis instead)")
    if args.content_dir:
        args.content = args.content_dir  # a preset's defaults parse it

    device = _device(args.device)

    import numpy as np

    from . import api
    from .autotune import autotune
    from .utils import io, runtime

    cfg = config_from_args(args, argv)
    size = args.size if args.size > 0 else None

    if args.spatial:
        return _run_spatial(args, cfg, size, device)

    if args.content_dir:
        if args.autotune:
            raise SystemExit(
                "--autotune tunes one pair; use it with --content, "
                "not --content-dir")
        return _run_batch_dir(args, cfg, size, device)

    masks = {}
    if args.content_masks:
        masks["content_masks"] = np.load(args.content_masks)
    if args.style_masks:
        masks["style_masks"] = np.load(args.style_masks)

    callback = None
    if args.intermediate_dir:
        os.makedirs(args.intermediate_dir, exist_ok=True)

        def callback(step, image, hist):
            path = os.path.join(args.intermediate_dir,
                                f"iter_{step:05d}.png")
            io.save_image(image.detach().cpu().numpy(), path)
            terms = hist[-1].cpu().numpy()
            if np.any(terms[1:]):
                print(f"  step {step}: total={terms[0]:.4g} "
                      f"content={terms[1]:.4g} style={terms[2]:.4g} "
                      f"photoreal={terms[3]:.4g}", flush=True)
            else:
                print(f"  step {step}: total={terms[0]:.4g}", flush=True)

    t0 = time.perf_counter()
    # the whole run in one trace: the config's own profile_dir would open
    # a second one inside it
    with runtime.maybe_profile(args.profile_dir or ""):
        run_cfg = dataclasses.replace(cfg, profile_dir="")
        if args.autotune:
            res = autotune(
                args.content, args.style, run_cfg, size=size,
                gammas=args.gamma_candidates, rounds=args.tune_rounds,
                device=device if args.device is not None else None,
                **masks)
            out, history = res.best_image, None
            print(f"autotune: best Γ = {res.best_gamma:g} "
                  f"(NIMA {res.scores.max():.3f}); candidates: "
                  + ", ".join(f"{g:g}:{s:.3f}" for g, s in
                              zip(res.gammas, res.scores)))
        else:
            out, history = api.stylize(
                args.content, args.style, run_cfg, size=size,
                callback=callback, resume=args.resume,
                return_history=True, device=device, **masks)
    dt = time.perf_counter() - t0

    io.save_image(out, args.output)
    print(f"wrote {args.output}  ({out.shape[1]}x{out.shape[0]}, "
          f"{dt:.1f}s)")
    if args.metrics:
        from .ops import metrics
        content_ref = io.load_image(args.content, out.shape[:2])
        s_val = float(metrics.ssim(np.asarray(out), content_ref))
        p_val = float(metrics.psnr(np.asarray(out), content_ref))
        print(f"vs content: SSIM={s_val:.4f} PSNR={p_val:.2f} dB "
              "(structure preservation; style transfer lowers these "
              "by design - compare across runs, not to 1.0)")
    # --resume from a checkpoint at or past the requested iteration count
    # yields an empty (0, 5) history: nothing to print or write
    if history is not None and len(history):
        _print_final(history)
        if args.loss_csv:
            _write_csv(args.loss_csv, history)
    return 0


if __name__ == "__main__":
    sys.exit(main())
