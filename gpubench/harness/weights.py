"""Seeded weights, made on the device in one call.

A configuration file names, for each net, an ordered list of rules
[regex, rule] matched against the net's parameter names (first match
wins). Every parameter that a random rule covers takes a slice of one
N(0, 1) draw on the device, scaled to its rule's standard deviation, so a
seed gives the same weights to the program and to the reference.

Rules: "keep" (the value the program's build gives, which the reference
builds alike: the template's leaves), "zeros", "ones", {"const": [values]}, {"normal": std}, "lecun"
(std 1 / sqrt(fan_in)), "kaiming" (sqrt(2 / fan_in)) and "kaiming_t"
(kaiming with the input channels on axis 0, as a transposed convolution
keeps them). fan_in is the product of every axis but the output one.
"""
from __future__ import annotations

import math
import re

import torch


def _fan_in(shape, transposed: bool) -> int:
    if len(shape) < 2:
        raise ValueError(f"fan_in of a {len(shape)}-D leaf")
    out_axis = 1 if transposed else 0
    return math.prod(s for i, s in enumerate(shape) if i != out_axis)


def _rule_for(name: str, rules) -> object:
    for pattern, rule in rules:
        if re.search(pattern, name):
            return rule
    raise KeyError(f"no weight rule matches {name!r}")


def _std(rule, shape):
    if isinstance(rule, dict) and "normal" in rule:
        return float(rule["normal"])
    if rule == "lecun":
        return 1.0 / math.sqrt(_fan_in(shape, False))
    if rule == "kaiming":
        return math.sqrt(2.0 / _fan_in(shape, False))
    if rule == "kaiming_t":
        return math.sqrt(2.0 / _fan_in(shape, True))
    return None


def make_weights(nets: dict, seed: int, device) -> dict:
    """nets: {net name: (list of (param name, shape)), rules} ->
    {net name: {param name: float32 tensor on `device`}}. One draw from a
    torch.Generator on `device` seeded with `seed` feeds every random
    leaf, in the order the nets and their parameters are given."""
    device = torch.device(device)
    plan, total = [], 0
    for net, (leaves, rules) in nets.items():
        for name, shape in leaves:
            rule = _rule_for(name, rules)
            if rule == "keep":
                continue
            std = _std(rule, shape)
            n = math.prod(shape)
            plan.append((net, name, tuple(shape), rule, std, total if std is not None else None))
            if std is not None:
                total += n
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out = {net: {} for net in nets}
    for net, name, shape, rule, std, offset in plan:
        if offset is not None:
            t = flat[offset:offset + math.prod(shape)].view(shape) * std
        elif rule == "zeros":
            t = torch.zeros(shape, device=device)
        elif rule == "ones":
            t = torch.ones(shape, device=device)
        elif isinstance(rule, dict) and "const" in rule:
            t = torch.tensor(rule["const"], dtype=torch.float32, device=device).reshape(shape)
        else:
            raise ValueError(f"{name}: unknown weight rule {rule!r}")
        out[net][name] = t
    return out


def leaves_of(module: torch.nn.Module) -> list:
    """(name, shape) of a module's parameters, the order make_weights takes."""
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into the module's parameters of the same names."""
    params = dict(module.named_parameters())
    unknown = set(weights) - set(params)
    if unknown:
        raise KeyError(f"{module.__class__.__name__} has no parameters {sorted(unknown)[:4]}")
    for name, t in weights.items():
        params[name].copy_(t)
