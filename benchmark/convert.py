"""Moving the same inputs and states between the program's containers and
the reference's. Both sides use NamedTuples with the same names and fields
(the reference is a copy of the port's float64 path), so a container is
rebuilt field by field as the same-named class of the other side."""

from __future__ import annotations

import torch


def retype(tree, types: dict, fn=lambda x: x):
    """`tree` with every NamedTuple rebuilt as `types[class name]`, dicts as
    dicts, and `fn` applied to every tensor leaf (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = types[type(tree).__name__]
        return cls(**{k: retype(v, types, fn)
                      for k, v in zip(tree._fields, tree)})
    if isinstance(tree, dict):
        return {k: retype(v, types, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(retype(v, types, fn) for v in tree)
    return fn(tree)


def floats_to(dtype, device):
    """A leaf function: floating tensors cast to `dtype` on `device`,
    integer and boolean tensors moved only."""
    def fn(x):
        if not torch.is_tensor(x):
            return x
        if x.is_floating_point():
            return x.to(device=device, dtype=dtype)
        return x.to(device)
    return fn


def types_of(*modules) -> dict:
    """{class name: class} of the NamedTuple classes the modules define."""
    out = {}
    for mod in modules:
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and issubclass(obj, tuple) \
                    and hasattr(obj, "_fields"):
                out[name] = obj
    return out
