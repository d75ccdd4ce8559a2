#!/usr/bin/env python3
"""Probes of the PyTorch/CUDA port (dpst_tpu_torch) on one NVIDIA GPU,
outside chip_smoke.py's run: the measurements that PERF.md §6 cites for
the 64² fp32 L-BFGS trajectory, the bf16 L-BFGS batch and the batched
kernels' plans.

    python3 chip_probes.py                     # the first three, one H100
    python3 chip_probes.py lbfgs64 bf16-batch  # the named ones
    python3 chip_probes.py lbfgs-host --tree DIR
    python3 chip_probes.py batch-kernels plans-rate convs-rate
    python3 chip_probes.py band-rows

Each probe prints one JSON line, and chiprun_out/chip_probes.jsonl gets
it too.
  lbfgs64     chip_smoke.run_spatial_lbfgs_small's 64² fp32 pair, 10
              L-BFGS steps, unsharded and on 4 row shards, on the CPU and
              on the card with its fp32 convs on ATen's own kernels
              (`vgg.conv2d`) or on cuDNN (F.conv2d): SSIM and history rows
              of each pair of runs and the first search decision apart
              (`record_evaluations`' traces); the card's run under
              gradient noise of 1e-8 and 1e-7 of max|g| (the trajectory's
              own sensitivity); one evaluation card against CPU and
              sharded against unsharded along the card's run; the
              Laplacian's Λ made on the card with each division by 9 a
              division by the number (which the card takes through the
              reciprocal) and with `laplacian.exact_div`, against the
              CPU's.
  conv-fp32   fp32 3×3 convs at a 512² VGG's shapes, ATen's own
              (`vgg._AtenConv`) and cuDNN's: forward and input gradient
              ms (CUDA events), and whether a batch of 4 is its images one
              at a time bit for bit.
  conv-bf16   the same in bf16 on a batch of 8, in turns: `vgg.conv2d`
              (cuDNN one image a call), one cuDNN call for the batch and
              ATen's own; whether each is its images bit for bit.
  bf16-batch  the batch phase's bf16 L-BFGS batch of 8 512² pairs
              (chip_smoke.run_batch_lbfgs) against each pair alone, twice,
              then with the batch's bf16 convs as one cuDNN call.
  batch-kernels
              chip_smoke.py's checks of the kernels on a batch (the
              block12 entry points at B = 2 and 3, the batched Gram,
              pool, Laplacian and conv kernels at B = 8, each pair bit
              for bit against its one-pair launch, timed in turns with
              one-pair launches and with the plans that split a pair's
              reductions by B), outside the smoke run.
  plans-rate  the batch phase's 8 pairs at 512², config3, on the shipped
              plans and on chip_smoke.plans_split_by_b, in turns
              (shipped, by B, by B, shipped): Adam pair-it/s over
              BATCH_ITERS steps and the L-BFGS batch's pair-evaluations/s
              over BATCH_LBFGS_ITERS steps, after a warm-up each.
  convs-rate  the same, shipped (a bf16 batch's convs one cuDNN call an
              image) against one cuDNN call for the batch.
  band-rows   the four block12 entry points at config6's 4096² step in
              bands of each of chip_smoke.B12_HEIGHTS rows (32 … 256;
              `band_rows` picks 256 there): every output against bands of
              32 rows (bit-equal, max |diff|), device ms by CUDA events in
              turns (32 … 256, 256 … 32), device ms by kernel group at
              each height, and the scratch each takes.
  lbfgs-host  one pair's 512² config3 L-BFGS through `stylize`, 100
              steps three times: evaluations/s of the port in DIR (this
              checkout by default; another commit unpacked with `git
              archive`, for an A/B in one process order of the caller's).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs

CARD = "cuda"
CONV_SHAPES = ((3, 64, 512), (64, 64, 512), (64, 128, 256), (128, 128, 256),
               (128, 256, 128), (256, 256, 128), (256, 512, 64),
               (512, 512, 64), (512, 512, 32))


def emit(name: str, obj) -> None:
    cs.emit({"probe": name, **obj})
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_probes.jsonl", "a") as fh:
        fh.write(json.dumps({"probe": name, **obj}) + "\n")


@contextlib.contextmanager
def convs_on(route: str):
    """The port's fp32 convs as shipped ("aten") or on cuDNN ("cudnn")."""
    from dpst_tpu_torch.models import vgg
    shipped = vgg.conv2d
    if route == "cudnn":
        vgg.conv2d = lambda x, w, padding=1: F.conv2d(x, w, padding=padding)
    try:
        yield
    finally:
        vgg.conv2d = shipped


@contextlib.contextmanager
def gradient_noise(sigma: float, seed: int):
    """Each evaluation's input gradient plus sigma · max|g| · N(0, 1) (max|g|
    that of the first evaluation; the values untouched)."""
    from dpst_tpu_torch import optimize
    shipped = optimize.make_loss_fn

    def make(cfg):
        fn = shipped(cfg)
        scale = {}

        def loss(im, consts, w, p):
            total, terms = fn(im, consts, w, p)
            if not im.requires_grad:
                return total, terms
            if "g" not in scale:
                (g,) = torch.autograd.grad(total, im, retain_graph=True)
                scale["g"] = float(g.abs().max())
                scale["gen"] = torch.Generator(
                    device=im.device).manual_seed(seed)
            noise = torch.randn(im.shape, generator=scale["gen"],
                                device=im.device) * (sigma * scale["g"])
            kick = torch.sum(im * noise)
            return total + (kick - kick.detach()), terms
        return loss
    optimize.make_loss_fn = make
    try:
        yield
    finally:
        optimize.make_loss_fn = shipped


def lbfgs64_inputs(dev) -> tuple:
    """run_spatial_lbfgs_small's 64² pair and masks, drawn as it draws them
    (the spatial phase's generator past its 4096², 512² and 64² pairs)."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 22)
    for size in (cs.SP_SIZE, cs.SIZE):
        cs.smooth_image(gen, dev, size)
        cs.textured_image(gen, dev, size)
    cs.smooth_image(gen, dev, 64)
    cs.smooth_image(gen, dev, 64)
    cs.smooth_image(gen, dev, cs.SIZE)
    cs.textured_image(gen, dev, cs.SIZE)
    content = cs.smooth_image(gen, dev, 64)
    style = cs.smooth_image(gen, dev, 64)
    return (content, style) + cs.stripe_masks(3, 64)


def first_decision_apart(a: list, b: list) -> dict | None:
    """The first step and evaluation where two runs' searches decide apart
    (the rule that proposed an evaluation, its verdict, or the next
    stepsize), from each step's trace; None where they decide alike."""
    for step, (ta, tb) in enumerate(zip(a, b)):
        for i, (x, y) in enumerate(zip(ta, tb)):
            key = ("rule", "done", "failed")
            if [x[k] for k in key] != [y[k] for k in key]:
                return {"step": step, "evaluation": i, "a": x, "b": y}
            if i + 1 < min(len(ta), len(tb)) and (ta[i + 1]["stepsize"]
                                                  != tb[i + 1]["stepsize"]):
                return {"step": step, "evaluation": i + 1, "a": ta[i + 1],
                        "b": tb[i + 1]}
        if len(ta) != len(tb):
            return {"step": step, "lengths": [len(ta), len(tb)]}
    return None


def probe_lbfgs64(dev) -> None:
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import laplacian as lap
    from dpst_tpu_torch.parallel import spatial as sp
    from dpst_tpu_torch.utils.runtime import params_on
    content, style, cm, sm = lbfgs64_inputs(dev)
    cfg = dpst_tpu_torch.StylizeConfig(
        compute_dtype="float32", iterations=cs.LBFGS_SHORT,
        optimizer="lbfgs", regularization_weight=100.0)
    ucfg = dataclasses.replace(cfg.spmd_safe(), laplacian_impl="xla")
    params = vgg.init_params(cs.SEED)

    def run(where, shards, iterations=cs.LBFGS_SHORT):
        c = dataclasses.replace(cfg, iterations=iterations)
        with optimize.record_evaluations() as rec:
            if shards:
                img, hist = sp.stylize_spatial(
                    content, style, cm, sm, c, params,
                    sp.make_spatial_mesh(devices=[where] * shards))
                img, hist = img.cpu().numpy(), hist.cpu().numpy()
            else:
                img, hist = dpst_tpu_torch.stylize(
                    content, style, dataclasses.replace(
                        ucfg, iterations=iterations), content_masks=cm,
                    style_masks=sm, vgg_params=params, return_history=True,
                    device=where)
        return img, hist, [r["pairs"][0]["trace"] for r in rec]

    def apart(a, b):
        e = cs.lbfgs_trajectory_errors(a[0], a[1], b[0], b[1])
        rel = np.asarray(e["rel_err_per_row"])
        return {"ssim": e["ssim"], "row0": float(rel[0]),
                "rows_0_9": float(rel[:10].max()),
                "first_row_apart": (int(np.argmax(rel > 0))
                                    if (rel > 0).any() else None),
                "golden_bad": cs.lbfgs_bounds_bad(e, cs.LBFGS_ROW0_TOL),
                "first_decision_apart": first_decision_apart(a[2], b[2])}

    t0 = time.perf_counter()
    runs = {"cpu 1": run("cpu", 0), "cpu 4": run("cpu", 4)}
    for route in ("aten", "cudnn"):
        with convs_on(route):
            runs[f"card {route} 1"] = run(CARD, 0)
            runs[f"card {route} 4"] = run(CARD, 4)
    names = [("card aten 1", "cpu 1"), ("card aten 4", "cpu 4"),
             ("card aten 4", "card aten 1"), ("card cudnn 1", "cpu 1"),
             ("card cudnn 4", "cpu 4"), ("card cudnn 4", "card cudnn 1"),
             ("card cudnn 1", "card aten 1"), ("cpu 4", "cpu 1")]
    runs_apart = {f"{a} | {b}": apart(runs[a], runs[b]) for a, b in names}
    noisy = {}
    for sigma in (1e-8, 1e-7):
        with gradient_noise(sigma, cs.SEED + 30):
            noisy[f"sigma {sigma:g}"] = apart(run(CARD, 0),
                                              runs["card aten 1"])

    def value_grad(img, where, shards):
        if shards:
            return cs.sharded_value_grad(img, where, cfg, params, content,
                                         style, cm, sm)
        p = params_on(params, torch.device(where))
        arrays = [torch.from_numpy(np.asarray(a)).to(where)
                  for a in (content, style, cm, sm)]
        consts = dpst_tpu_torch.prepare_constants(*arrays, ucfg, p)
        x = torch.from_numpy(np.asarray(img)).to(where).requires_grad_(True)
        total, _ = optimize.make_loss_fn(ucfg)(
            x, consts, optimize.LossWeights.from_config(ucfg), p)
        (g,) = torch.autograd.grad(total, x)
        return float(total.detach()), g.cpu()

    def rel(a, b):
        return {"value": abs(a[0] - b[0]) / abs(b[0]),
                "grad_max": float((a[1] - b[1]).abs().max()
                                  / b[1].abs().max()),
                "grad_l2": float((a[1] - b[1]).norm() / b[1].norm())}

    one = {}
    for step in (0, 1, 2, 4, 9):
        img = content if step == 0 else run(CARD, 0, step)[0]
        cpu = value_grad(img, "cpu", 0)
        row = {"card aten | cpu": rel(value_grad(img, CARD, 0), cpu),
               "card aten 4 | card aten 1": rel(
                   value_grad(img, CARD, 4), value_grad(img, CARD, 0))}
        with convs_on("cudnn"):
            row["card cudnn | cpu"] = rel(value_grad(img, CARD, 0), cpu)
        one[f"step {step}"] = row
    # the Laplacian's Λ on the card: divisions by the number 9, then
    # exact_div, each against the CPU's
    image01 = lap.exact_div(torch.from_numpy(content), 255.0)
    lam_cpu = lap.precompute_stats(image01).lam
    scale = float(lam_cpu.abs().max())
    lam = {}
    shipped = lap.exact_div
    for name, div in (("by the number", lambda x, d: x / d),
                      ("exact_div", shipped)):
        lap.exact_div = div
        try:
            got = lap.precompute_stats(image01.to(dev)).lam.cpu()
        finally:
            lap.exact_div = shipped
        lam[name] = {"max_abs_over_max": float(
            (got - lam_cpu).abs().max()) / scale,
            "bit_equal": bool(torch.equal(got, lam_cpu))}
    emit("lbfgs64", {"steps": cs.LBFGS_SHORT, "runs_apart": runs_apart,
                     "card_aten_1_under_gradient_noise": noisy,
                     "one_evaluation": one, "lambda_card_vs_cpu": lam,
                     "seconds": time.perf_counter() - t0})


def probe_conv_fp32(dev) -> None:
    from dpst_tpu_torch.models import vgg
    vgg.set_exact_backends("float32")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 31)
    rows = []
    for cin, cout, hw in CONV_SHAPES:
        x = torch.randn((4, cin, hw, hw), device=dev, generator=gen)
        w = torch.randn((cout, cin, 3, 3), device=dev, generator=gen) * 0.05
        gy = torch.randn((4, cout, hw, hw), device=dev, generator=gen)

        def fwd_bwd(conv, xs, gys):
            xs = xs.clone().requires_grad_(True)
            y = conv(xs, w)
            return y, torch.autograd.grad(y, xs, gys)[0]
        aten = lambda t, w: vgg._AtenConv.apply(t, w, 1)  # noqa: E731
        cudnn = lambda t, w: F.conv2d(t, w, padding=1)  # noqa: E731
        y, gx = fwd_bwd(aten, x, gy)
        invariant = all(
            torch.equal(a, b[i:i + 1]) for i in range(4)
            for a, b in zip(fwd_bwd(aten, x[i:i + 1], gy[i:i + 1]),
                            (y, gx)))
        ms = {}
        for name, conv in (("aten_ms", aten), ("cudnn_ms", cudnn)):
            ms[name] = cs.cuda_ms(lambda conv=conv: fwd_bwd(
                conv, x[:1], gy[:1]), warmup=2, iters=5)
        rows.append({"cin": cin, "cout": cout, "size": hw,
                     "batch_of_4_is_its_images": invariant, **ms})
    emit("conv-fp32", {"what": "one image's forward and input gradient",
                       "rows": rows,
                       "aten_ms_total": sum(r["aten_ms"] for r in rows),
                       "cudnn_ms_total": sum(r["cudnn_ms"] for r in rows)})


def probe_conv_bf16(dev) -> None:
    from dpst_tpu_torch.models import vgg
    vgg.set_exact_backends("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 32)
    b, rows = cs.BATCH, []
    for cin, cout, hw in CONV_SHAPES:
        x = torch.randn((b, cin, hw, hw), device=dev,
                        generator=gen).bfloat16()
        w = (torch.randn((cout, cin, 3, 3), device=dev, generator=gen)
             * 0.05).bfloat16()
        gy = torch.randn((b, cout, hw, hw), device=dev,
                         generator=gen).bfloat16()

        def fwd_bwd(conv, xs, gys):
            xs = xs.clone().requires_grad_(True)
            y = conv(xs, w)
            return y, torch.autograd.grad(y, xs, gys)[0]
        convs = {"each_image_cudnn": lambda t, w: vgg.conv2d(t, w, 1),
                 "one_cudnn_call": lambda t, w: F.conv2d(t, w, padding=1),
                 "aten": lambda t, w: vgg._AtenConv.apply(t, w, 1)}
        row = {"cin": cin, "cout": cout, "size": hw}
        for name, conv in convs.items():
            y, gx = fwd_bwd(conv, x, gy)
            row[name + "_is_its_images"] = all(
                torch.equal(a, c[i:i + 1]) for i in range(b)
                for a, c in zip(fwd_bwd(conv, x[i:i + 1], gy[i:i + 1]),
                                (y, gx)))
        for name, conv in [*convs.items(), *reversed(convs.items())]:
            row[name + "_ms"] = row.get(name + "_ms", 0.0) + cs.cuda_ms(
                lambda conv=conv: fwd_bwd(conv, x, gy), warmup=2,
                iters=5) / 2
        rows.append(row)
    emit("conv-bf16", {"what": f"a batch of {b}: forward and input "
                       "gradient, in turns", "rows": rows, **{
                           name + "_ms_total": sum(r[name + "_ms"]
                                                   for r in rows)
                           for name in ("each_image_cudnn",
                                        "one_cudnn_call", "aten")}})


def probe_bf16_batch(dev, smi: str) -> None:
    import dpst_tpu_torch
    from dpst_tpu_torch.models import vgg
    t0 = time.perf_counter()
    _, b = cs.run_batch_path(dev, torch.Generator(device=dev).manual_seed(
        cs.SEED + 21), smi)
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              optimizer="lbfgs",
                              iterations=cs.BATCH_LBFGS_ITERS)

    def pairs():
        return [{"ssim": e["ssim"], "row0": e["rel_err_per_row"][0],
                 "rows_0_9": max(e["rel_err_per_row"][:10]),
                 "all": max(e["rel_err_per_row"]),
                 "evaluation_steps_apart": e["evaluation_steps_apart"]}
                for e in cs.lbfgs_batch_vs_alone(b, cfg)[-1]]
    out = {"run 1": pairs(), "run 2": pairs()}
    with bf16_convs_batched():
        out["the batch's bf16 convs in one cuDNN call"] = pairs()
    emit("bf16-batch", {"B": cs.BATCH, "size": cs.SIZE,
                        "steps": cs.BATCH_LBFGS_ITERS, **out,
                        "seconds": time.perf_counter() - t0})


def probe_batch_kernels(dev) -> None:
    t0 = time.perf_counter()
    cs.check_block12_batch(dev, torch.Generator(device=dev).manual_seed(
        cs.SEED + 25))
    cs.check_batched(dev, torch.Generator(device=dev).manual_seed(
        cs.SEED + 20))
    cs.check_batched_wbwd_conv(dev, torch.Generator(device=dev).manual_seed(
        cs.SEED + 24))
    emit("batch-kernels", {"seconds": time.perf_counter() - t0})


def probe_band_rows(dev) -> None:
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.ops import block12_pallas as b12
    t0 = time.perf_counter()
    h = w = cs.B12_SIZE
    params = vgg.init_params(cs.SEED, device=dev)
    calls, res = cs.b12_step_calls(
        params, dev, torch.Generator(device=dev).manual_seed(cs.SEED + 27))
    got = calls["block12_fwd_res"][0]()
    res["a11"], res["a21_a22"] = got[3], got[4:]
    del got
    res["dp1"] = calls["block12_bwd_deep"][0]()
    equal = cs.b12_heights_equal(calls, cs.B12_HEIGHTS[1:])
    heights = list(cs.B12_HEIGHTS)
    ms = {name: {rows: [] for rows in heights} for name in calls}
    for name, (kernel, _) in calls.items():
        for rows in heights + heights[::-1]:
            with cs.b12_bands_of(rows):
                ms[name][rows].append(cs.cuda_ms(kernel, warmup=1, iters=3))
    stages, scratch = {}, {}
    for rows in heights:
        group = b12.group_bands(h, w, rows)
        scratch[rows] = [b12.scratch_bytes(which, cs.K, h, w, group,
                                           "bfloat16", rows) / 1e9
                         for which in range(3)]
        with cs.b12_bands_of(rows):
            stages[rows] = {name: cs.stage_ms(kernel)
                            for name, (kernel, _) in calls.items()}
    emit("band-rows", {
        "shape": [h, w], "K": cs.K, "dtype": "bfloat16",
        "band_rows": b12.band_rows(h, w),
        "equal_max_abs_diff_to_32_rows": equal,
        "all_equal": all(same for same, _ in equal.values()),
        "ms_in_turns": ms,
        "ms": {name: {rows: sum(v) / len(v) for rows, v in by.items()}
               for name, by in ms.items()},
        "device_ms_by_stage": stages,
        "scratch_gb_fwd_deep_shallow": scratch,
        "seconds": time.perf_counter() - t0})
    del calls, res
    torch.cuda.empty_cache()


@contextlib.contextmanager
def bf16_convs_batched():
    """A bf16 batch's convs on the card as one cuDNN call for the batch (the
    port takes one call an image: `vgg.conv2d`)."""
    from dpst_tpu_torch.models import vgg
    shipped = vgg.conv2d

    def conv(x, w, padding=1):
        if x.dtype == torch.bfloat16:
            return F.conv2d(x, w, padding=padding)
        return shipped(x, w, padding)
    vgg.conv2d = conv
    try:
        yield
    finally:
        vgg.conv2d = shipped


def batch_rates(dev, smi: str, name: str, control) -> None:
    """The batch phase's 8 pairs at 512², config3, as shipped and under the
    context `control`, in turns (shipped, control, control, shipped): Adam
    pair-it/s over BATCH_ITERS steps and the L-BFGS batch's
    pair-evaluations/s over BATCH_LBFGS_ITERS steps, a warm-up before
    each."""
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.parallel import batch as pb
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    contents = np.stack([cs.smooth_image(gen, dev, cs.SIZE)
                         for _ in range(cs.BATCH)])
    styles = np.stack([cs.textured_image(gen, dev, cs.SIZE)
                       for _ in range(cs.BATCH)])
    cm, sm = cs.batch_masks(cs.BATCH, cs.SIZE)
    inputs = [torch.from_numpy(a).to(dev) for a in (contents, styles, cm, sm)]
    params = vgg.get_params(seed=cs.SEED, device=dev)
    out = {}
    for opt, steps in (("adam", cs.BATCH_ITERS),
                       ("lbfgs", cs.BATCH_LBFGS_ITERS)):
        cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                                  optimizer=opt, iterations=steps)
        rcfg = pb.resolve_config(cfg)
        pp = vgg.pack_params(params, rcfg.compute_dtype, rcfg.conv_impl)
        weights = optimize.LossWeights.from_config(rcfg)
        consts, cs_, means = pb.prepare_batch_stage(
            *inputs, pp, (cs.SIZE, cs.SIZE), rcfg)
        img0 = optimize.init_image(rcfg, cs_, means)

        def rate(n):
            with optimize.record_evaluations() as rec:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pb.run_batch(img0, consts, weights, pp, rcfg, n)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            if opt == "adam":
                return cs.BATCH * n / dt
            return cs.BATCH * cs.lbfgs_evaluations(rec)["E"] / dt
        rates = {"shipped": [], "control": []}
        for which in ("shipped", "control", "control", "shipped"):
            ctx = control() if which == "control" else contextlib.nullcontext()
            with ctx:
                rate(3)
                rates[which].append(rate(steps))
        out[opt] = {"steps": steps, "unit": "pair-it/s" if opt == "adam"
                    else "pair-evaluations/s", **rates,
                    "means": {k: sum(v) / len(v) for k, v in rates.items()}}
        del consts, cs_, means, img0
        torch.cuda.empty_cache()
    emit(name, {"B": cs.BATCH, "size": cs.SIZE, **out, "nvidia_smi": smi})


def probe_lbfgs_host(dev, tree: str) -> None:
    import dpst_tpu_torch
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    content = cs.smooth_image(gen, dev, cs.SIZE)
    style = cs.smooth_image(gen, dev, cs.SIZE)
    cm, sm = cs.band_masks(0), cs.band_masks(1)
    params = vgg.get_params(seed=cs.SEED, device=dev)
    cfg = dataclasses.replace(dpst_tpu_torch.PRESETS["config3"],
                              optimizer="lbfgs")

    def run(n):
        with optimize.record_evaluations() as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dpst_tpu_torch.stylize(
                content, style, dataclasses.replace(cfg, iterations=n),
                content_masks=cm, style_masks=sm, vgg_params=params)
            torch.cuda.synchronize()
            return sum(r["evaluations"] for r in rec) / (
                time.perf_counter() - t0)
    run(5)
    emit("lbfgs-host", {"tree": tree, "port": os.path.dirname(
        dpst_tpu_torch.__file__), "evaluations_per_s": [
            run(100) for _ in range(3)]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    tree = "."
    if "--tree" in args:
        i = args.index("--tree")
        tree = args[i + 1]
        del args[i:i + 2]
        sys.path.insert(0, os.path.abspath(tree))
    from dpst_tpu_torch.ops import kernels
    names = args or ["lbfgs64", "conv-fp32", "bf16-batch"]
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kernels.build()
    for name in names:
        {"lbfgs64": lambda: probe_lbfgs64(dev),
         "conv-fp32": lambda: probe_conv_fp32(dev),
         "conv-bf16": lambda: probe_conv_bf16(dev),
         "bf16-batch": lambda: probe_bf16_batch(dev, smi),
         "batch-kernels": lambda: probe_batch_kernels(dev),
         "plans-rate": lambda: batch_rates(dev, smi, "plans-rate",
                                           cs.plans_split_by_b),
         "convs-rate": lambda: batch_rates(dev, smi, "convs-rate",
                                           bf16_convs_batched),
         "band-rows": lambda: probe_band_rows(dev),
         "lbfgs-host": lambda: probe_lbfgs_host(dev, tree)}[name]()
    emit("device", {"nvidia_smi": smi})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
