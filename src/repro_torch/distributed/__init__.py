"""Gradient compression, checkpointing and fault tolerance on one device,
and the bitmap-index scatter/gather serving tier.

The reference's mesh sharding rules are not ported: on one device every
sharding constraint is the identity.

Submodules import lazily — ``checkpoint``/``fault_tolerance``/
``grad_compression`` pull in torch, while ``wire`` is stdlib+NumPy only
and ``cluster`` needs only the host side of the query engine."""

_LAZY = ("checkpoint", "fault_tolerance", "grad_compression", "wire",
         "cluster")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
