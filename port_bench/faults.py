"""Faults planted under the timed path, to show that the check fails them:
each a context manager that patches the program while it is active.

- `unchanged`: every Adam step returns its image and state unchanged.
- `half_batch`: the loss of a batch takes its first half only, scaled to
  stand for the whole, and gives the other half the first half's mean
  terms (so those pairs never move).
- `altered`: every Adam step adds one learning rate to the red channel
  of its update (an answer altered where it is produced).
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged():
    import torch
    from dpst_tpu_torch import optimize

    def update(self, grad, state):
        return torch.zeros_like(grad), state
    return _patched(optimize.Adam, "update", update)


def half_batch():
    import torch
    from dpst_tpu_torch import optimize
    make = optimize.make_loss_fn

    def make_loss_fn(cfg):
        loss = make(cfg)

        def half(image, consts, weights, vgg_params):
            if image.dim() != 4 or image.shape[0] < 2:
                return loss(image, consts, weights, vgg_params)
            b, h = image.shape[0], image.shape[0] // 2
            total, terms = loss(image[:h], consts.map(lambda t: t[:h]),
                                weights, vgg_params)
            rest = terms.mean(0, keepdim=True).expand(b - h, -1)
            return total * (b / h), torch.cat([terms, rest])
        return half
    return _patched(optimize, "make_loss_fn", make_loss_fn)


def altered():
    from dpst_tpu_torch import optimize
    update = optimize.Adam.update

    def red(self, grad, state):
        step, state = update(self, grad, state)
        step[..., 0] += self.lr
        return step, state
    return _patched(optimize.Adam, "update", red)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
