"""A request of one pair through `dpst_tpu_torch.stylize`, with the run's
weights (`vgg_params=`) and the pair's masks, and a callback every
`stamp_every` steps (`intermediate_interval`) that syncs and stamps; the
callback cuts the request at the window's end.

`stylize` does its precompute inside the call, so the request's precompute
is the time to the first stamp less that stamp's steps at the window's
mean step time.
"""
from __future__ import annotations

import dataclasses

import torch

from port_bench.entries import Request


class _Cut(Exception):
    """Raised from the callback to end a request at the window's end."""


def resolve(cfg):
    return cfg


def run_request(ctx, pairs, request: Request) -> None:
    import dpst_tpu_torch

    (content, style, cmasks, smasks), = pairs
    cfg = dataclasses.replace(ctx.cfg, iterations=request.steps,
                              intermediate_interval=request.stamp_every)

    def callback(step, image, hist):
        request.keep(image, hist)
        if request.stamp(step, final=step == request.steps):
            raise _Cut

    request.begin(precompute_inside=True)
    try:
        with torch.profiler.record_function("port_bench.request"):
            dpst_tpu_torch.stylize(content, style, cfg, content_masks=cmasks,
                                   style_masks=smasks, vgg_params=ctx.params,
                                   callback=callback, device=ctx.device)
    except _Cut:
        pass
