"""Gradient compression, checkpointing and fault tolerance on one device,
the bitmap-index scatter/gather serving tier, and the mesh sharding rules
(``sharding``: the reference's rules as pure functions of a mesh
descriptor; on one device every sharding constraint is the identity).

Submodules import lazily — ``checkpoint``/``fault_tolerance``/
``grad_compression`` pull in torch, while ``wire`` is stdlib+NumPy only
and ``cluster`` needs only the host side of the query engine."""

_LAZY = ("checkpoint", "fault_tolerance", "grad_compression", "wire",
         "cluster", "sharding")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
