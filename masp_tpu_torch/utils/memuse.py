# Rewrite of masp_tpu/utils/memuse.py: register, dynamic_usage and dynamic_usage_bounds are
# verbatim copies; device_usage counts torch storages. The port imports nothing of
# masp_tpu.
"""Memory-usage accounting (the `memuse` crate's DynamicUsage equivalent).

``dynamic_usage(obj)`` returns the bytes retained beyond the object header
(0 for plain values, recursive for containers), as the reference's
``memuse::DynamicUsage``; ``dynamic_usage_bounds(obj)`` the (lower, upper)
pair. ``device_usage(*objs)`` counts the device bytes reachable from torch
tensors, containers of them and the prover's ``Parameters.device`` cache:
the proving queries, their split halves, the stacked or lanes layouts and
a BGMW table, which bound what fits on a card.
"""

from __future__ import annotations

import torch

__all__ = [
    "dynamic_usage", "dynamic_usage_bounds", "register", "device_usage",
]

_REGISTRY: dict[type, object] = {}


def register(cls):
    """Class decorator: use the class's own ``dynamic_usage`` method."""

    def deco(fn):
        _REGISTRY[cls] = fn
        return fn

    if not isinstance(cls, type):
        raise TypeError("register(cls) takes the type to account for")
    return deco


def dynamic_usage(obj) -> int:
    """Bytes of dynamically-held memory retained by ``obj``.

    Mirrors memuse semantics: by-value scalars cost 0; containers cost
    their element storage plus elements' own dynamic usage."""
    fn = _REGISTRY.get(type(obj))
    if fn is not None:
        return fn(obj)
    if obj is None or isinstance(obj, (int, float, bool)):
        return 0
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, str):
        return len(obj.encode())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return 8 * len(obj) + sum(dynamic_usage(x) for x in obj)
    if isinstance(obj, dict):
        return 16 * len(obj) + sum(
            dynamic_usage(k) + dynamic_usage(v) for k, v in obj.items()
        )
    du = getattr(obj, "dynamic_usage", None)
    if callable(du):
        return du()
    # plain value object (dataclass-like): account its slots/dict fields
    fields = getattr(obj, "__slots__", None)
    if fields is not None:
        return sum(dynamic_usage(getattr(obj, f, None)) for f in fields)
    d = getattr(obj, "__dict__", None)
    if d is not None:
        return dynamic_usage(d)
    return 0


def dynamic_usage_bounds(obj) -> tuple[int, int | None]:
    """(lower, upper) bounds; exact for everything we account."""
    n = dynamic_usage(obj)
    return (n, n)


def device_usage(*objs) -> int:
    """Total bytes of the distinct device storages reachable from ``objs``.

    Accepts torch tensors, dicts, lists and tuples of them, the shards of a
    sharded tensor (parallel/mesh.py) and objects whose ``device`` is a dict
    (the prover's ``Parameters``). A view shares its base's storage, which a
    jax.Array never does, so each storage counts once, whole, by its data
    pointer: views, and a tensor reached twice, add nothing. A tensor on
    the CPU counts as the reference counts a jax.Array on its CPU backend."""
    seen: set[tuple] = set()
    total = 0

    def visit(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            key = (str(x.device), st.data_ptr())
            if key not in seen:
                seen.add(key)
                total += st.nbytes()
            return
        if isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(getattr(x, "shards", None), dict):
            visit(x.shards)
        elif isinstance(getattr(x, "device", None), dict):
            visit(x.device)

    for o in objs:
        visit(o)
    return total
