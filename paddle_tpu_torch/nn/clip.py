"""Gradient clipping (ports ``paddle_tpu/nn/clip.py``; reference
python/paddle/nn/clip.py), applied inside ``optimizer.step`` on
``(param, grad)`` pairs of torch tensors; the norms are taken in
float32."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _sq(g):
    return torch.sum(torch.square(g.float()))


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g) if g is None or not getattr(p, "need_clip", True)
                else (p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            n = torch.sqrt(_sq(g))
            factor = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                 max=1.0)
            out.append((p, (g.float() * factor).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads):
        sq = [_sq(g) for g in grads if g is not None]
        if not sq:
            return torch.zeros((), dtype=torch.float32)
        return torch.sqrt(torch.stack(sq).sum())

    def __call__(self, params_grads):
        gn = self.global_norm([g for p, g in params_grads
                               if g is not None
                               and getattr(p, "need_clip", True)])
        factor = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12),
                             max=1.0)
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
            else:
                out.append((p, (g.float() * factor).to(g.dtype)))
        return out
