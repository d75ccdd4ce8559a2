"""The deep-photo objective (Luan et al., arXiv:1703.07511, on Gatys et
al.'s masked Gram style loss) and Adam, in plain PyTorch: the reference
that a cell's outputs are held to.

    total = w_c · ½·mean((F_l − F^c_l)²)            (the content tap l)
          + w_s · Σ_l w_l Σ_k cov_k / (4 C_l²) · ‖G_lk − G^s_lk‖²
          + λ · Σ_c v_cᵀ L v_c,  v = image / 255    (matting Laplacian)

G_lk = Σ_p m_k(p)² f_p f_pᵀ / Σ_p m_k(p)², the masks averaged down to each
tap; cov_k the content masks' share Σ m_k² / Σ_j Σ m_j². Adam (bias
corrections, ε outside the root) then a clip to [0, 255] after each step,
from the content image.

The image is walked in blocks of rows, each run through VGG with `halo`
rows on either side, so that the reference fits at any size: a tap's rows
that a block owns see none of its cut edges when the halo covers the
network's reach. A first pass sums the Grams and the content term; a
second runs each block again under autograd with the taps' cotangents,
which the Grams fix, and sums the blocks' input gradients.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import laplacian, vgg
from port_bench.reference.precision import Precision


@dataclass
class Objective:
    """The configuration's terms, read from its file's "stylize" fields."""
    blocks: list
    style_layers: tuple
    style_weights: tuple
    content_layer: str
    content_weight: float
    style_weight: float
    reg_weight: float
    pooling: str
    eps: float
    lr: float
    b1: float
    b2: float
    adam_eps: float

    @staticmethod
    def from_config(config: dict) -> "Objective":
        s = config["stylize"]
        for key, want in (("style_norm", "gatys"), ("mask_downsample", "avg"),
                          ("init_mode", "content"), ("clip_pixels", True),
                          ("optimizer", "adam"), ("tv_weight", 0.0),
                          ("use_photorealism", True)):
            if s[key] != want:
                raise ValueError(f"the reference runs {key}={want!r}, "
                                 f"not {s[key]!r}")
        if len(s["content_layers"]) != 1:
            raise ValueError("the reference runs one content tap")
        # the weights as the configuration's float32 numbers
        f32 = lambda x: float(np.float32(x))
        return Objective(
            blocks=config["vgg19_blocks"],
            style_layers=tuple(s["style_layers"]),
            style_weights=tuple(f32(w) for w in s["style_layer_weights"]),
            content_layer=s["content_layers"][0],
            content_weight=f32(s["content_weight"]),
            style_weight=f32(s["style_weight"]),
            reg_weight=f32(s["regularization_weight"]),
            pooling=s["pooling"], eps=s["matting_epsilon"],
            lr=s["learning_rate"], b1=s["adam_b1"], b2=s["adam_b2"],
            adam_eps=s["adam_eps"])

    @property
    def layers(self) -> tuple:
        return tuple(dict.fromkeys(self.style_layers + (self.content_layer,)))


def _blocks(h: int, rows: int, halo: int):
    """(own start, own end, run start, run end) of each block of rows."""
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        yield r0, r1, max(0, r0 - halo), min(h, r1 + halo)


def _own(tap: torch.Tensor, layer: str, r0: int, r1: int, a0: int):
    s = vgg.stride(layer)
    return tap[:, (r0 - a0) // s:(r1 - a0) // s]


def _pyramid(masks: torch.Tensor, layers) -> dict:
    """{layer: (K, H_l, W_l)} masks averaged over each tap's stride."""
    return {l: F.avg_pool2d(masks[None], vgg.stride(l))[0]
            if vgg.stride(l) > 1 else masks for l in layers}


def _gram(f: torch.Tensor, m2: torch.Tensor, prec: Precision
          ) -> torch.Tensor:
    """Σ_p m²_k(p) f_p f_pᵀ of a (C, h, w) tap over (K, h, w) squared
    masks: (K, C, C) float64."""
    fq = prec.round(f.flatten(1))
    out = []
    for mk in m2.flatten(1):
        out.append((fq @ prec.round(fq * mk).t()).to(torch.float64))
    return torch.stack(out)


class Pair:
    """One pair's constants: the content tap, the style Grams, the content
    masks' pyramid, norms and coverage, and the Laplacian's statistics."""

    def __init__(self, obj: Objective, params: dict, content, style,
                 cmasks, smasks, prec: Precision, rows: int, halo: int):
        self.obj, self.params, self.prec = obj, params, prec
        self.rows, self.halo = rows, halo
        self.content = content
        spyr = _pyramid(smasks, obj.style_layers)
        self.cpyr = _pyramid(cmasks, obj.style_layers)
        self.norms = {l: torch.clamp_min((m.double() ** 2).sum((1, 2)), 1e-8)
                      for l, m in self.cpyr.items()}
        snorms = {l: torch.clamp_min((m.double() ** 2).sum((1, 2)), 1e-8)
                  for l, m in spyr.items()}
        area = (cmasks.double() ** 2).sum((1, 2))
        self.coverage = area / torch.clamp_min(area.sum(), 1e-8)
        raw = {l: 0.0 for l in obj.style_layers}
        feat = []
        with torch.no_grad():
            for r0, r1, a0, a1 in _blocks(style.shape[0], rows, halo):
                t = vgg.taps(params, style[a0:a1], obj.style_layers,
                             obj.blocks, obj.pooling, prec)
                for l in obj.style_layers:
                    s = vgg.stride(l)
                    raw[l] = raw[l] + _gram(_own(t[l], l, r0, r1, a0),
                                            spyr[l][:, r0 // s:r1 // s] ** 2,
                                            prec)
            for r0, r1, a0, a1 in _blocks(content.shape[0], rows, halo):
                t = vgg.taps(params, content[a0:a1], (obj.content_layer,),
                             obj.blocks, obj.pooling, prec)
                feat.append(_own(t[obj.content_layer], obj.content_layer,
                                 r0, r1, a0))
        self.style_grams = {l: raw[l] / snorms[l][:, None, None]
                            for l in obj.style_layers}
        self.content_feat = torch.cat(feat, 1)
        self.lap = laplacian.stats(content, obj.eps)

    def loss_and_grad(self, image: torch.Tensor):
        """(terms [total, content, style, photoreal, tv], gradient) at an
        (H, W, 3) image."""
        obj, prec, cl = self.obj, self.prec, self.obj.content_layer
        h = image.shape[0]
        raw = {l: 0.0 for l in obj.style_layers}
        sq = 0.0
        with torch.no_grad():
            for r0, r1, a0, a1 in _blocks(h, self.rows, self.halo):
                t = vgg.taps(self.params, image[a0:a1], obj.layers,
                             obj.blocks, obj.pooling, prec)
                for l in obj.style_layers:
                    s = vgg.stride(l)
                    raw[l] = raw[l] + _gram(_own(t[l], l, r0, r1, a0),
                                            self.cpyr[l][:, r0 // s:r1 // s]
                                            ** 2, prec)
                s = vgg.stride(cl)
                d = (_own(t[cl], cl, r0, r1, a0)
                     - prec.round(self.content_feat[:, r0 // s:r1 // s]))
                sq += float((d.double() ** 2).sum())
        n_content = self.content_feat.numel()
        content = 0.5 * sq / n_content
        style, cots = 0.0, {}
        for l, wl in zip(obj.style_layers, obj.style_weights):
            c = self.style_grams[l].shape[-1]
            g = raw[l] / self.norms[l][:, None, None]
            diff = g - self.style_grams[l]
            cw = self.coverage / (4.0 * c * c)
            style += wl * float((cw * (diff ** 2).sum((1, 2))).sum())
            # d total / d raw Gram_k, symmetrized: the tap's cotangent is
            # Σ_k m²_k ∘ (S_k f)
            d_raw = (obj.style_weight * wl * 2.0 * cw[:, None, None] * diff
                     / self.norms[l][:, None, None])
            cots[l] = (d_raw + d_raw.transpose(1, 2)).to(torch.float32)
        photo, grad_photo = laplacian.photoreal(self.lap, image)
        grad = obj.reg_weight * grad_photo
        for r0, r1, a0, a1 in _blocks(h, self.rows, self.halo):
            x = image[a0:a1].detach().requires_grad_(True)
            t = vgg.taps(self.params, x, obj.layers, obj.blocks,
                         obj.pooling, prec)
            surrogate = 0.0
            for l in obj.style_layers:
                s = vgg.stride(l)
                f = _own(t[l], l, r0, r1, a0)
                m2 = self.cpyr[l][:, r0 // s:r1 // s] ** 2
                fd = f.detach().flatten(1)
                cot = sum(m2[k].flatten() * (cots[l][k] @ fd)
                          for k in range(m2.shape[0]))
                surrogate = surrogate + (prec.round(cot) * f.flatten(1)).sum()
            s = vgg.stride(cl)
            f = _own(t[cl], cl, r0, r1, a0)
            cot = (obj.content_weight / n_content) * (
                f.detach() - prec.round(self.content_feat[:, r0 // s:r1 // s]))
            surrogate = surrogate + (prec.round(cot) * f).sum()
            (g,) = torch.autograd.grad(surrogate, x)
            grad[a0:a1] += g
        total = (obj.content_weight * content + obj.style_weight * style
                 + obj.reg_weight * photo)
        return [total, content, style, photo, 0.0], grad


def adam_run(pair: Pair, steps: int) -> tuple[np.ndarray, torch.Tensor]:
    """The (steps, 5) history of `steps` Adam steps from the content image
    (each row at the image before its step's update), and the image after
    the last step."""
    obj = pair.obj
    x = pair.content.to(torch.float32).clone()
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    rows = []
    for t in range(1, steps + 1):
        terms, g = pair.loss_and_grad(x)
        rows.append(terms)
        mu = obj.b1 * mu + (1 - obj.b1) * g
        nu = obj.b2 * nu + (1 - obj.b2) * g * g
        mhat = mu / (1 - obj.b1 ** t)
        vhat = nu / (1 - obj.b2 ** t)
        x = torch.clamp(x - obj.lr * mhat / (torch.sqrt(vhat) + obj.adam_eps),
                        0.0, 255.0)
    return np.asarray(rows, np.float64), x


def reference_run(config: dict, params: dict, pairs, steps: int,
                  prec: Precision, rows: int, halo: int, device
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(history rows (B, steps, 5), images after `steps` steps (B, H, W,
    3)) of each pair ((content, style, content masks, style masks) numpy
    arrays) under `config`, computed on `device` with TF32 off."""
    if any(pr[2] is None for pr in pairs):
        raise ValueError("the objective reference takes the traffic's masks; "
                         "a traffic that leaves them to the program needs a "
                         "reference module that makes its own")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    obj = Objective.from_config(config)
    hist, images = [], []
    for pr in pairs:
        t = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
             for a in pr]
        p = Pair(obj, params, *t, prec, rows, halo)
        h, x = adam_run(p, steps)
        hist.append(h)
        images.append(x.cpu().double().numpy())
        del p, t, x
    return np.stack(hist), np.stack(images)
