"""Gradient compression, checkpointing and fault tolerance on one device.

The reference's mesh sharding rules are not ported: on one device every
sharding constraint is the identity.
"""
