"""Weights made on the device from ``--seed``, one tensor at a time.

Each tensor is drawn from a generator of its own, seeded from (seed,
tenant, tensor name), straight into storage of the type it is served in:
the program's parameters are filled in place, with no copy on the host
and no float32 temporary.  The plain reference asks for the same name
and gets the same numbers (:func:`draw`), so it can make any layer's
weights again when it reaches that layer, without holding a second copy
of the model.

The distributions: N(0, fan_in^-1/2) for every matrix (fan_in = its first
dimension, as the program's ``x @ w`` layout has it), N(0, 0.02) for the
token table and biases, and N(0, 0.1) for the norm scales, which the
program applies as ``1 + scale``, so that the comparison reaches them.
"""
from __future__ import annotations

import hashlib

import torch

NORM_STD = 0.1
TABLE_STD = 0.02
NORMS = ("ln", "final_ln")
SMALL = ("tok", "bq", "bk", "bv")


def tensor_seed(seed: int, tenant: str, name: str) -> int:
    """A 63-bit generator seed for one tensor."""
    h = hashlib.sha256(f"{seed}/{tenant}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def std_of(name: str, shape) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in NORMS:
        return NORM_STD
    if leaf in SMALL:
        return TABLE_STD
    if len(shape) != 2:
        raise ValueError(f"no distribution for {name} of shape {tuple(shape)}")
    return shape[0] ** -0.5


@torch.no_grad()
def fill_(t: torch.Tensor, seed: int, tenant: str, name: str) -> torch.Tensor:
    """Draw tensor ``name`` of ``tenant`` into ``t`` in place."""
    gen = torch.Generator(device=t.device)
    gen.manual_seed(tensor_seed(seed, tenant, name))
    return t.normal_(0.0, std_of(name, t.shape), generator=gen)


def draw(seed: int, tenant: str, name: str, shape, dtype: torch.dtype,
         device) -> torch.Tensor:
    """Tensor ``name`` of ``tenant`` as :func:`fill_` makes it."""
    return fill_(torch.empty(tuple(shape), dtype=dtype, device=device),
                 seed, tenant, name)


@torch.no_grad()
def fill_model(model: torch.nn.Module, seed: int, tenant: str) -> None:
    """Fill every parameter of ``model`` in place."""
    for name, p in model.named_parameters():
        fill_(p.data, seed, tenant, name)
