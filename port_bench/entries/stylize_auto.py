"""A request of one pair through `dpst_tpu_torch.stylize` with no masks and
`use_segmentation` on, so that the program makes them as the CLI's
one-photo run does: PSPNet-50 on both photos (`seg_params=`), the class
merge on the host, one-hot masks over `max_classes`. The run's VGG weights
(`vgg_params=`) and a callback every `stamp_every` steps
(`intermediate_interval`) that syncs and stamps, and cuts the request at
the window's end.

PSPNet's weights are drawn on the run's first (warm-up) request from the
configuration's seed (`reference.pspnet.weights`, as the reference draws
them) and held on the run's context.

`stylize` segments and precomputes inside the call, so the request's
precompute (segmentation included) is the time to the first stamp less
that stamp's steps at the window's mean step time.
"""
from __future__ import annotations

import dataclasses

import torch

from port_bench.entries import Request
from port_bench.reference import pspnet


class _Cut(Exception):
    """Raised from the callback to end a request at the window's end."""


def resolve(cfg):
    if not cfg.use_segmentation:
        raise ValueError("the automatic-mask entry runs use_segmentation "
                         "on")
    return cfg


def run_request(ctx, pairs, request: Request) -> None:
    import dpst_tpu_torch

    (content, style, cmasks, smasks), = pairs
    if cmasks is not None or smasks is not None:
        raise ValueError(f"traffic {ctx.traffic!r} hands over masks; the "
                         "automatic-mask entry leaves them to the program "
                         '("masks": "program")')
    seg = getattr(ctx, "seg_params", None)
    if seg is None:
        seg = ctx.seg_params = pspnet.weights(ctx.cfg.seed, ctx.device)
    cfg = dataclasses.replace(ctx.cfg, iterations=request.steps,
                              intermediate_interval=request.stamp_every)

    def callback(step, image, hist):
        request.keep(image, hist)
        if request.stamp(step, final=step == request.steps):
            raise _Cut

    request.begin(precompute_inside=True)
    try:
        with torch.profiler.record_function("port_bench.request"):
            dpst_tpu_torch.stylize(content, style, cfg, vgg_params=ctx.params,
                                   seg_params=seg, callback=callback,
                                   device=ctx.device)
    except _Cut:
        pass
