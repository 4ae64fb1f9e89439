"""RNG state.

Ports ``paddle_tpu/framework/random.py``'s API (``seed``,
``get_rng_state``/``set_rng_state``, ``Generator``,
``default_generator``) over explicit ``torch.Generator``s, one per
device, made on first use from the generator's seed.  The reference
threads JAX PRNG keys; those streams cannot be reproduced here, so the
port's random draws match the reference in distribution, not in value.
"""
from __future__ import annotations

import torch

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "generator_for"]


class Generator:
    def __init__(self, seed_: int = 0):
        self._seed = int(seed_)
        self._gens: dict[str, torch.Generator] = {}

    def manual_seed(self, seed_: int):
        self._seed = int(seed_)
        self._gens.clear()
        return self

    seed = manual_seed

    def initial_seed(self):
        return self._seed

    def for_device(self, device) -> torch.Generator:
        """This generator's stream on ``device`` (a torch device; "cuda"
        means the current card, one stream with "cuda:N")."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        g = self._gens.get(key)
        if g is None:
            g = torch.Generator(device=key).manual_seed(self._seed)
            self._gens[key] = g
        return g

    def get_state(self):
        return {"seed": self._seed,
                "streams": {k: g.get_state() for k, g in self._gens.items()}}

    def set_state(self, state):
        self._seed = int(state["seed"])
        self._gens.clear()
        for key, st in state["streams"].items():
            self.for_device(key).set_state(st)


default_generator = Generator(0)


def seed(s: int):
    """paddle.seed."""
    default_generator.manual_seed(int(s))
    return default_generator


def get_rng_state():
    return default_generator.get_state()


def set_rng_state(state):
    default_generator.set_state(state)


def generator_for(device) -> torch.Generator:
    """The default generator's stream on ``device``: what every random op
    draws from (the reference's ``split_key``)."""
    return default_generator.for_device(device)
