"""A request of B pairs through what `stylize_batch` runs on one card:
`parallel.batch.prepare_batch_stage`, then its Adam steps under the config
`stylize_batch` resolves (`parallel.batch.resolve_config`).

`parallel.batch.batch_steps` is `optimize.adam_segment` from a fresh
Adam state, and hands out the images only at its end; the request takes
the same steps through `optimize.adam_segment` a stamp at a time, the
Adam state carried from one segment to the next (as `optimize.run` does
between its callbacks), so that the image at each stamp is seen.

The request's precompute (its inputs to the card, the weights packed as
`stylize_batch` packs them, the batched constants) is synchronized and
timed; its steps are stamped by a sync every `stamp_every` steps. It
takes the traffic's masks: a traffic that leaves them to the program
(`"masks": "program"`) is refused.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.entries import Request


def resolve(cfg):
    from dpst_tpu_torch.parallel import batch as pb
    return pb.resolve_config(cfg)


def run_request(ctx, pairs, request: Request) -> None:
    from dpst_tpu_torch import optimize
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.parallel import batch as pb

    cfg, dev = ctx.cfg, ctx.device
    if any(p.content_masks is None for p in pairs):
        raise ValueError(
            f"traffic {ctx.traffic!r}: the batch entry takes the traffic's "
            "masks, and this traffic leaves them to the program")
    request.begin()
    with torch.profiler.record_function("port_bench.precompute"):
        arrays = [torch.from_numpy(np.stack([p[i] for p in pairs])).to(dev)
                  for i in range(4)]
        packed = vgg.params_by_device(ctx.params, [dev], cfg.compute_dtype,
                                      cfg.conv_impl)[arrays[0].device]
        h, w = arrays[0].shape[1:3]
        consts, contents, means = pb.prepare_batch_stage(
            *arrays, packed, (h, w), cfg)
        images = optimize.init_image(cfg, contents, means)
    if request.precomputed():
        return
    weights = optimize.LossWeights.from_config(cfg)
    state = optimize.init_opt_state(optimize.make_optimizer(cfg), cfg, images)
    done = 0
    while done < request.steps:
        n = min(request.stamp_every, request.steps - done)
        seg = optimize.adam_segment(images, state, consts, weights, packed,
                                    n, cfg, first_step=done)
        try:
            while True:
                with torch.profiler.record_function("port_bench.step"):
                    next(seg)
        except StopIteration as stop:
            images, state, hist = stop.value
        done += n
        request.keep(images, hist)
        if request.stamp(done, final=done == request.steps):
            return
