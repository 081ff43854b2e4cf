"""Proportion's deserved water-filling
(pkg/scheduler/plugins/proportion/proportion.go:132-196): each round grants
every unmet queue ``remaining * weight/totalWeight``, clamps to capability
and request, and stops when nothing moves. One round is a masked vector
update over ``f32[Q,R]``.

Two forms with one semantics, as in the JAX package: a NumPy twin that the
plugin uses below 64 queues, and torch ops on the session's device at 64 or
more (the JAX package's ``lax.while_loop``; its loop condition is read back
once a round here), whose sums over the queue axis follow XLA:CPU's order,
so it gives the JAX loop's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Epsilon from resource_info.go:36. `l < r or |l-r| < eps` == `l < r + eps`.
EPS = 0.1


class ProportionResult(NamedTuple):
    deserved: object        # f32[Q,R] (numpy or torch, as computed)
    share: object           # f32[Q]


def proportion_deserved_numpy(total, weight, request, capability, allocated,
                              max_iters: int = 64) -> ProportionResult:
    """The water-filling in NumPy, for small queue counts."""
    total = np.asarray(total, np.float32).copy()
    weight = np.asarray(weight, np.float32)
    request = np.asarray(request, np.float32)
    capability = np.asarray(capability, np.float32)
    allocated = np.asarray(allocated, np.float32)
    Q, R = request.shape

    deserved = np.zeros_like(request)
    meet = np.zeros(Q, dtype=bool)
    remaining = total
    for _ in range(max_iters):
        active = ~meet
        total_w = weight[active].sum()
        if total_w <= 0 or not (remaining >= EPS).any():
            break
        grant = remaining[None, :] * (weight / max(total_w, 1e-9))[:, None]
        new_deserved = deserved + np.where(active[:, None], grant, 0.0)

        over_cap = active & ~np.all(new_deserved < capability + EPS, axis=-1)
        req_met = active & ~over_cap & np.all(request < new_deserved + EPS,
                                              axis=-1)
        capped = np.minimum(np.minimum(new_deserved, capability), request)
        clamped = np.minimum(new_deserved, request)
        new_deserved = np.where(over_cap[:, None], capped,
                                np.where(req_met[:, None],
                                         np.minimum(new_deserved, request),
                                         np.where(active[:, None], clamped,
                                                  deserved)))
        meet = meet | over_cap | req_met
        delta = (new_deserved - deserved).sum(axis=0)
        remaining = remaining - delta
        deserved = new_deserved
        if not (np.abs(delta) >= EPS).any():
            break

    denom = np.maximum(deserved, 0.0)
    ratio = np.where(denom > 0, allocated / np.where(denom > 0, denom, 1.0),
                     np.where(allocated > 0, 1.0, 0.0))
    return ProportionResult(deserved=deserved, share=ratio.max(axis=-1))


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the queue axis in the order XLA:CPU gives the JAX loop's
    ``jnp.sum`` at --xla_backend_optimization_level=0: up to 32 queues one
    after the other from 0; beyond, the axis padded with zeros to a
    multiple of 32 (the smaller half of the padding before it), each window
    of 32 summed in order from 0, and the window sums summed the same way
    (its reduce-window rewrite). A fixed order, so the f32 result does not
    depend on how a library splits a reduction."""
    Q = x.shape[0]
    if Q > 32:
        pad = -Q % 32
        lo = pad // 2
        x = torch.cat([x.new_zeros((lo, *x.shape[1:])), x,
                       x.new_zeros((pad - lo, *x.shape[1:]))])
        x = x.reshape(-1, 32, *x.shape[1:]).transpose(0, 1)
    acc = torch.zeros_like(x[0])
    for q in range(x.shape[0]):
        acc = acc + x[q]
    return _sum0(acc) if Q > 32 else acc


def proportion_deserved(total, weight, request, capability, allocated,
                        device, max_iters: int = 64) -> ProportionResult:
    """The water-filling as torch ops on ``device``; inputs are f32 NumPy
    arrays (capability +inf where unlimited), results stay on the device."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    remaining, weight, request = t(total), t(weight), t(request)
    capability, allocated = t(capability), t(allocated)
    Q, R = request.shape
    deserved = torch.zeros_like(request)
    meet = torch.zeros(Q, dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    moved = True
    for _ in range(max_iters):
        active = ~meet
        total_w = _sum0(torch.where(active, weight, zero))
        if not (moved and bool(total_w > 0)
                and bool((remaining >= EPS).any())):
            break
        grant = remaining[None, :] * (
            weight / torch.clamp_min(total_w, 1e-9))[:, None]
        new = deserved + torch.where(active[:, None], grant, zero)
        over_cap = active & ~torch.all(new < capability + EPS, dim=-1)
        req_met = active & ~over_cap & torch.all(request < new + EPS, dim=-1)
        capped = torch.minimum(torch.minimum(new, capability), request)
        clamped = torch.minimum(new, request)
        new = torch.where(over_cap[:, None], capped,
                          torch.where(req_met[:, None],
                                      torch.minimum(new, request),
                                      torch.where(active[:, None], clamped,
                                                  deserved)))
        meet = meet | over_cap | req_met
        delta = _sum0(new - deserved)
        remaining = remaining - delta
        moved = bool((delta.abs() >= EPS).any())
        deserved = new
    denom = torch.clamp_min(deserved, 0.0)
    one = torch.ones((), dtype=torch.float32, device=device)
    ratio = torch.where(denom > 0,
                        allocated / torch.where(denom > 0, denom, one),
                        torch.where(allocated > 0, one, zero))
    return ProportionResult(deserved=deserved, share=ratio.max(dim=-1).values)
